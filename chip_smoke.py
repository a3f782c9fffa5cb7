#!/usr/bin/env python3
"""Drive the PyTorch port (``repro_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; one card

Phases (any failure exits non-zero; nothing is caught and passed over):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; build the CUDA kernels of ``src/repro_torch/csrc`` and
   print the build time and each kernel's registers/spills; for every
   ``local_attention`` instance, every instance of its backward
   (``local_attn_bwd``) and every tensor-core instance of the
   block sweeps (``block_matvec_tc``: bf16; ``block_matvec_tf32``: fp32
   as 3xTF32) its registers, spills (and for attention its dynamic
   shared memory) and tensor-core instructions (``HGMMA``/``HMMA`` in
   the library's SASS, ``cuobjdump -sass``).  Fails unless the path's
   instances (attention bf16 D = 256; the backward's
   ``bwd_dkdv_wgmma<D>`` and ``bwd_dq_wgmma<D>`` at D = 64, 128, 256;
   the sweeps' ``matvec_tc<32,LD>``
   and ``rmatvec_tc<LD>`` for LD = 0, 8, 4, 2: A by TMA, by cp.async of
   8 and of 4 bytes, and with register copies of rows 2 bytes off; and
   ``matvec_tf32<32,CP>`` and ``rmatvec_tf32<32,CP>`` for CP = 0, 1, 2:
   A by TMA, by cp.async of 4 and of 8 bytes; k = 32;
   and every instance of ``gram_tf32<TRANS,CP>``, ``A^T A`` and
   ``A A^T`` for CP = 0, 1, 2, and of ``gram_bf16<TRANS,LD>``, LD = 0
   by TMA and 1 by the producer's own copies) have tensor-core
   instructions and spill nothing.  Beside the real build, eight planted
   faults for phase 2b: ``block_matvec_tc.cu`` with
   ``-DREPRO_TC_SUMS_ONLY`` and with ``-DREPRO_NO_ZFILL``,
   ``block_matvec_tf32.cu`` with
   ``-DREPRO_TF32_ONLY``, with ``-DREPRO_TC_SUMS_ONLY`` and with
   ``-DREPRO_NO_ZFILL``, ``gram_tf32.cu`` with ``-DREPRO_TF32_ONLY`` and
   with ``-DREPRO_TC_SUMS_ONLY``, and ``gram_bf16.cu`` with
   ``-DREPRO_TC_SUMS_ONLY``; for timing alone, ``gram_bf16.cu`` and
   ``block_matvec_tc.cu`` with ``-DREPRO_STAGING_ONLY`` (no products);
   and, read in phase 12, ``local_attn_bwd.cu`` with
   ``-DREPRO_TWO_TERMS`` and ``-DREPRO_TC_SUMS_ONLY``.  Each
   ``csr_sweep`` kernel's registers and spills too (CUB's among them);
   fails unless the sparse path's instances (``CSR_PATH``) spill nothing;
   and each ``wkv6`` kernel's, failing unless every backward instance
   (``WKV6_BWD_PATH``, one a head size) spills nothing.
2. every kernel on the card against its plain PyTorch version
   (``repro_torch/kernels/ref.py``): ``block_matvec``, ``block_rmatvec``
   and ``block_gram_chain`` (both orientations), fp32 and bf16, at
   ragged shapes, each with the route that ran it (``tf32x3``: fp32 on
   the tensor cores, A by TMA; ``tf32x3_cpasync``: the same where no
   tensor map describes A, A by cp.async; ``wgmma``: bf16 on them, A by
   TMA; ``wgmma_ld``: bf16 no tensor map describes, A copied by the
   kernel's producer; read from the route launch counts); the same on
   views of padded rows whose padding is NaN (``padded_views``: a kernel
   that reads past a row returns NaN), the bf16 ones as
   ``DenseOperator`` pads its copy and on ``wgmma_ld`` (a base 2 bytes
   off, an odd row stride, an odd n in rows of even stride); and at the
   main path's 262144 x 32768, k = 32, with the relative Frobenius error
   and its limit; kernel, plain, library (``torch.matmul``, a yardstick
   only) and bound (by route) times at that shape (the
   ``tf32x3_cpasync`` and ``wgmma_ld`` kernels' on the odd-width inputs
   of phase 3, after their solves).  Then the planted faults the limit
   must reject, against the
   real sweeps, on a 65536 x 32768 |N(0, 1)| ``A`` (bf16 for
   ``block_matvec_tc``, fp32 for ``block_matvec_tf32``) with skinny
   operands uniform in [0, 1) (every partial sum grows, as a truncating
   accumulator likes least) and, in fp32, on a signed N(0, 1) input (the
   sums cancel, so the products' rounding is not averaged away): the
   sums left in the tensor cores' accumulators for the whole reduction,
   not promoted to rounded adds every stage; and plain TF32, the
   ``hi hi`` term of 3xTF32 alone.  Each must read above the limit on at
   least one input.  The same three fp32 faults and the edge columns
   copied from past the row (``-DREPRO_NO_ZFILL``) on the cp.async
   route: 65536 x 32765 views of rows 32767 apart, padding NaN; the
   last fault must read outside the limit in ``block_matvec`` (in
   ``block_rmatvec`` the columns past n feed only output rows that are
   never stored); the same for bf16 on ``wgmma_ld`` (rows 32767 apart:
   every other row by registers) with its two faults, the sums left in
   the tensor cores and the edge columns copied.  And ``gram`` (fp32 on
   ``tf32x3`` with its two planted
   faults, bf16 on ``wgmma`` with its one) on 65536 x 2048 inputs (the
   gram path's aspect), |N(0, 1)| and signed N(0, 1): the real kernel
   within both of phase 4's gram readings on both, each fault outside the
   off-diagonal one on at least one.
3. the main path: ``repro_torch.svd(A, 32)`` with the default config on
   a 262144 x 32768 fp32 ``A`` (32 GiB, the paper's per-node shard)
   built on the card with singular values ``100 * 0.9**i`` (i < 64) plus
   noise far below them; sigma checked to rtol 1e-4, launch counts
   (by route: ``tf32x3``, chains and extraction) checked against the
   pass accounting, and a profile of it (device busy share, time by
   kernel).  Then ``sweep_dtype="bfloat16"`` (eps 1e-4, rtol 1e-2) on the
   same ``A``, its chains on the ``wgmma`` route (the extraction reads
   ``A`` in fp32: ``tf32x3``), and its profile; an fp32 input of odd
   width (65536 x 8190, rows no tensor map describes:
   ``tf32x3_cpasync`` end to end), with the sweeps timed there in fp32
   and, on ``wgmma_ld``'s path, in bf16 handed to ``ops`` directly (one
   chain, launches counted; rows 4-byte aligned: cp.async of 4 bytes),
   and the same at 65536 x 8191 (an odd row stride: every other row by
   registers), each with its staging-only build's times; the paper's
   shard one column short (262144 x 32767, after the main ``A`` is
   freed): the fp32 solve (``tf32x3_cpasync``) and the bf16 one (chains
   on ``wgmma``, reading the operator's copy padded to 32768 columns; the
   extraction on ``tf32x3_cpasync``), each with its profile, and the
   fp32 sweeps timed at that shape; and a contiguous wide input (the
   operator's transposed path).
4. the deflation kernels (``matvec``, ``deflate_rmatvec``, ``gram``,
   both layouts; ``gram`` symmetric and full on its route -- where a
   tensor map describes A fp32 ``tf32x3`` and bf16 ``wgmma``, else
   ``tf32x3_cpasync`` and ``wgmma_ld`` -- read from the route launch
   counts, B exactly symmetric; also on views whose row padding is NaN,
   bf16 ones with an odd row stride, an even one not a multiple of 8
   and a base 2 bytes off) against their
   plain versions at ragged shapes (relative Frobenius error, limit
   1e-5; ``gram`` 4 sqrt(r) 2^-24 for a reduction of length r, at least
   1e-5, see ``gram_tol``, and a second reading over the off-diagonal
   entries alone, ``gram_offdiag_err``, limit ``TOL_GRAM_OFFDIAG``: the
   whole product's error is the diagonal's, which plain TF32 leaves
   within ``gram_tol``), and at the deflation paths' shapes with kernel,
   plain, bound and library (a yardstick only) times; ``gram`` in bf16
   (no solve runs it) once through ``ops`` at the gram path's shape
   (``wgmma``), one column short (``wgmma_ld``) and, as ``A A^T``, on the
   wide input (``wgmma``) and on it one column short (8192 x 131071:
   ``wgmma_ld``), each timed beside
   ``torch.mm(..., out_dtype=torch.float32)``, the ``wgmma_ld`` ones also
   beside their staging-only build; and, printed only (not a route), a
   padded copy of the 262144 x 8191 bf16 ``A`` read by ``wgmma``.
5. the gram-free path: ``repro_torch.svd(A, 16, method="gramfree")`` on
   the same 262144 x 32768 ``A``; sigma within rtol 2e-3 of the
   prescribed spectrum (the JAX package's deflation tolerance), launches
   ``matvec`` sum(iters) + k and ``deflate_rmatvec`` sum(iters), passes
   3 sum(iters) + k.  Then the gram path: ``svd(A, 8, method="gram")`` on
   a 262144 x 8192 ``A`` (launches ``gram`` k, all on ``tf32x3``,
   ``matvec`` k; passes 3k); the same one column short (262144 x 8191,
   rows no tensor map describes: all on ``tf32x3_cpasync``, the kernel
   timed there); and both methods at k = 4 on the contiguous wide input
   (the ``trans`` kernels).
6. determinism: two block solves (fp32 on ``tf32x3``, and bf16 on
   ``wgmma``) and two gram-free solves of a 16384 x 4096 matrix, and two
   fp32 block solves of a 16384 x 4095 one (``tf32x3_cpasync``), each
   pair bitwise equal; and ``gram`` twice on each, both layouts, in fp32
   and in bf16 (``wgmma``, ``wgmma_ld``).
7. the LM serving path: the ``local_attention`` kernels (causal
   sliding-window attention, GQA, soft-cap; bf16 at D >= 64 on the
   tensor cores, the rest by FFMA) against their plain version at
   ragged shapes (fp32 and bf16, every head dim of its template) and at
   the path's shapes (gemma2-9b prefill: B = 2, H = 16, Hkv = 8,
   S = 8192, D = 256, bf16, soft-cap 50, window 4096 and window S; the
   plain version two heads at a time).  Each output element is held to
   its own limit (``attn_share``): fp32 within 1e-4, the JAX package's
   limit for its kernel; bf16 within the kernel's one rounding of its
   fp32 output to bf16, 2^-8 |o| of that element, plus 1e-5 for the
   fp32 sums' order.  At the path's shapes the same check must reject
   the kernel run with its window one key tile (64) short.  Then
   gemma2-9b at full width (42 layers, bf16, weights from seed 0)
   through ``repro_torch.launch.serve``'s functions: a prefill of 2
   prompts of 8192 tokens (twice the window, so the local mask and the
   local ring buffer both bite) with 42 kernel launches, checked, and
   32 greedy decode steps with none; prefill seconds, decode tokens/s,
   peak memory.  Consistency: the decode step's logits at position 8192
   against the last logits of a prefill over the 8193 tokens, relative
   Frobenius error at most ``TOL_CONSISTENCY``.  The two paths cannot
   agree bit for bit: the prefill runs the kernel on a ragged S with
   fp32 probabilities, the decode the plain cache path with bf16
   probabilities, and cuBLAS rounds the bf16 products of 8193 rows and
   of one row in other orders, compounded over 42 layers.  The limit,
   5e-2, is set from readings of this script, between the sound
   decode's (2.07e-2) and decodes with a fault planted in a copy of
   the cache (``planted_decode_faults``): the position off by one reads
   1.67e-1 and an empty cache 1.41, and these (``FAULTS_SEEN``) must
   read above the limit or the run fails.  One skipped cache slot reads
   2.34e-2, inside the bf16 noise at random weights: this check cannot
   see it.  A second check can (``smoke_cache_check``): the fp32 smoke
   config of gemma2-9b (2 layers, window 8) served on the card and on
   the CPU from the same seed-0 weights, a prefill of 12 tokens and 12
   decode steps (the local ring buffer wraps), every step's logits and
   every cache tensor within ``TOL_CACHE`` relative and the slots'
   positions equal; the same serve on the card with the last prompt
   position's slot skipped must read above ``TOL_CACHE``.
   Determinism: two prefills give bitwise-equal logits.  Times of the
   kernel per layer kind beside its bound, its plain version and
   ``scaled_dot_product_attention`` with a band mask (a yardstick only,
   timed without the soft-cap on both sides: no single PyTorch call
   soft-caps), and on the global layer also with ``is_causal=True`` and
   no mask tensor (the flash backend, the fastest single call for causal
   attention; ``library_causal_ms``).

8. the out-of-core tiers, on the kernels above: the host's memory,
   locked-memory limit and temp disk; the host -> device rate of one
   2 GiB block from pinned memory (the tiers' bound), from pageable
   memory and through ``core/staging.py``'s ring (one run of bytes, and
   the pitched copy into rows padded to 16 bytes).  The paper's shard
   (262144 x 32768 fp32, phase 3's A) in host memory:
   ``svd(CountingHostMatrix(A, 4), 32)`` in fp32 and bf16-staged, each
   held to the prescribed sigma and the dense solve's (rtol 1e-4, 1e-2),
   to passes = iters + 1, fetches = passes x 4, launches = 4 x passes by
   route (chains on ``tf32x3`` / ``wgmma``, the extraction on
   ``tf32x3``) and ``bytes_moved``; seconds a pass against
   ``bytes_per_pass`` / the pinned rate, and a profile (device busy, copy
   engine busy, kernel time, the share of it under a copy).  An input
   larger than the card, 655360 x 32768 fp32 (85.9 GB), built row block
   by row block into host memory: ``svd(A_numpy, 32)``, sigma to 1e-4,
   peak device memory below A's bytes.  Gram-free at k = 2 on 262144 x
   8192 host blocks (passes sum(2 it + 1), launches ``matvec`` 4 x
   sum(it + 1), ``deflate_rmatvec`` 4 x sum(it)); the streamed Gram
   against ``ops.gram`` of the whole A (phase 4's two readings); the
   disk tier on 131072 x 8192 of the same spectrum (cut in depth from
   262144 rows to keep the script under 850 s) staged in fp32 and bf16
   (``svd(path, 8)``: one
   file read with an unbounded host budget, one a pass with half the
   file as budget and the cache never above it, bf16 halving disk and
   H2D bytes; the files dropped from the page cache first); 65536 x
   8191 fp32 host blocks and a bf16-staged copy on ``tf32x3`` and
   ``wgmma`` (device rows padded), sigma equal to the dense solve's; and
   the demotion ladder under ``FaultSpec("device_oom", at=3)``: dense ->
   host-blocked and host-blocked -> memmap, sigma within 1e-4 of the
   clean solve, and under ``force_iters`` the iterations conserved and
   the passes each tier's count.  ``--only-out-of-core`` runs phases 1
   and 8 alone.
9. the paper's sparse stream on the CSR kernels (``csr_sweep.cu``), and
   resume.  The per-node share of the paper's 128 PB matrix,
   ``SyntheticSparseMatrix(33554432, 33554432, 33, seed=0)``
   (1,107,296,256 nonzeros, density 9.8e-7, 4.5 PB dense-equivalent):
   the kernels on its first and its ragged last row block
   (rows [m - 61437, m)) and on the first block with every nonzero moved
   to one column (one run as long as the block), fp32 and bf16 values,
   k = 8, each held BITWISE against ``np.add.at`` computed here (``A_b
   Q``; ``Z += A_b^T Y`` into a nonzero Z, the untouched rows of Z still
   0; the chain, y rounded to bf16 under bf16) and rerun bitwise; timed
   on the first block beside the plain version (``index_add_`` on the
   card), ``torch.sparse.mm`` (cuSPARSE; with bf16 values where the
   card's torch takes them, else the error is printed) and the bound,
   ``csr_rmatmat``'s sort and sum halves apart, each kernel read against
   the random-row ceiling (``row_gather`` of uniformly random 32-byte
   rows of a 1 GiB fp32 array, as many as the block's nonzeros); the
   long-run block timed alone.  Then ``svd(sp, 8,
   force_iters=True, max_iters=3)`` in fp32 and bf16 (the main path;
   3 iterations since phase 10 came: 6 before), passes 4, launches 512 blocks x passes by kernel and dtype,
   ``bytes_moved`` the JAX package's exactly, the factors finite and
   orthonormal; seconds a pass beside the host's packing rate, the PCIe
   bytes and rate, and (bf16, profiled) the CSR kernels' device time a
   pass beside the wall's, and the device idle share, against the pinned H2D rate of phase 8.1 (measured here under
   ``--only-sparse``).  A known spectrum: a 4194304 x 4194304 scipy CSR,
   ``SyntheticSparseMatrix(2^22, 2^22, 33, seed=1)`` scaled by 1e-6 plus
   64 entries 100 * 0.9^i at distinct rows and columns from seed 0
   (138 M nonzeros): ``svd(A, 32)`` sigma within rtol 1e-4, passes =
   iters + 1; the same matrix through ``save_npz(compressed=False)`` and
   ``svd(path, 32)``, sigma bitwise equal; the solve capped at 8
   iterations with ``checkpoint_dir`` and resumed, U, S, V bitwise the
   uncapped solve's with equal passes; gram-free at k = 2, sigma within
   2e-3, passes = sum(2 it + 1).  The dense shard of phase 3 capped and
   resumed the same way.  ``--only-sparse`` runs phases 1 and 9 alone.
10. the paper's N-GPU layout, ``svd(A, k, mesh=...)`` (``A`` row-sharded
   over a ``torch.distributed`` mesh, one ``(n, k)`` all-reduce a block
   step, the deflation engines' faithful and fused schedules), on a
   262144 x 32768 fp32 matrix separable by rows (``separable_matrix``:
   noise seeded per 1 GiB chunk, so any split over ranks builds the same
   bits).  10.1, one rank on NCCL (the card holds one; NCCL refuses two
   ranks on one GPU) at the paper's full per-node shard: the block solve
   (k = 32, default config) in fp32 and bf16, held to the spectrum and to
   the dense solve of the same ``A`` (rtol 1e-4; bf16 1e-2), launches
   to the pass accounting by route, the collectives to exactly one
   (32768, 32) fp32 all-reduce a step (4 MiB) and the extraction's
   (32, 32); the all-reduce timed alone and a profiled solve's NCCL
   kernel time; gram-free k = 16 and gram k = 8 on 262144 x 8192,
   faithful and fused: collectives a power step (3 and 1), launches and
   passes the reference's schedule.  10.2, four gloo ranks sharing the
   card (``torchrun --standalone``, this script with ``--sharded-rank``,
   under a timeout), each building and holding only its 65536 rows (8
   GiB) as a ``DTensor``: the block solve, sigma within 1e-4 of 10.1,
   ``U`` (gathered) orthonormal, S, V and iters bitwise on every rank, a
   rerun bitwise, each rank's rows bitwise 10.1's (checksums); a kill
   after iteration 8 and a resume from the first rank's checkpoint,
   bitwise; a wide 4096 x 65536 input (each rank copying its column
   slice); gram-free and gram at k = 4 on 65536 x 8192, faithful and
   fused, with their collectives; a planted device OOM at 16384 x 1024
   moving each rank's own 4096 rows to its host (the host-blocked tier,
   one all-reduce a step still).  gloo times on one
   card are not NCCL's between cards.  ``--only-sharded`` runs phases 1
   and 10 alone.
11. the SVD service (``repro_torch.serving``): one ``SVDService(max_workers=2,
   byte_budget=48 GiB)`` on the card serves, at once: the paper's shard
   (phase 3's 262144 x 32768 fp32 matrix, k = 32, default config,
   ``stream_every=4``), held to the plain ``repro_torch.svd`` of the same
   ``A`` (the same iterations, sigma rtol 1e-4), a partial every 4
   iterations; a second job on the same ``A`` at lower priority with a
   deadline and ``stream_every=1``, which the budget keeps queued until
   the first ends (its queue wait printed) and which is cancelled after
   its first partial; a host-blocked job (a 65536 x 8192 fp32 numpy
   array in a ``CountingHostMatrix``, 4 blocks: fetches n_blocks x
   passes); gram-free and gram jobs at k = 4 on the same rows on the
   card; a job with k > min(m, n) (``error_kind == "input"``).  Every
   launch of that window is read job by job (``Job.launches``, each
   worker's own tally) and equals that job's pass accounting by route
   (the shard jobs on ``tf32x3``, plus one ``block_matvec`` a partial),
   and the window's totals their sum;
   peak device memory under 80 GB.  Then two bursts of 256 jobs of 1024 x
   256 (the batcher's ``MAX_BATCH_ELEMS``), k = 8, ``warmup_q=1``, seeds
   0-255, one lane holding a NaN: fp32 (eps 1e-8) and bf16 (eps 1e-4),
   each in 16 batched dispatches of 16 (``torch.bmm``: no kernel of the
   port launches; TF32 off around them), every lane held to its job's
   standalone ``repro_torch.svd`` (sigma rtol 1e-4 for both dtypes:
   both sides start from the same ``Q0`` and round at the same points;
   subspace cosines > 1 - 1e-3), the NaN lane alone FAILED with
   ``NumericalHealthError``; the standalone solves, timed one by one (jobs
   a second against the batched service), launching the chains on
   ``tf32x3`` / ``wgmma`` to their pass accounting.  The cost records'
   integers equal the results' own, the metrics rollup is printed, and
   device memory returns to its level before the service once the
   results are dropped.  Beside them the kernels at these shapes against
   their plain versions, and ``deflate_rmatvec`` at 65536 x 8192, k = 16,
   re-timed against its two-call yardstick in turns (7 runs each).
   ``--only-serving`` runs phases 1 and 11 alone.
12. training (``repro_torch.training``).  12.1: the backward kernel of
   ``local_attention`` (``csrc/local_attn_bwd.cu``) against its plain
   version (``ref.local_attention_bwd_ref``) on the forward kernel's
   log-sum-exp, element by element (phase 7's rule: fp32 1e-4, bf16 half
   a bf16 step plus ``ATOL_ATTN_BF16``), at ragged shapes (every head
   dim, fp32 and bf16, each on the route ``local_attn.bwd_route`` names:
   bf16 at D >= 64 on the tensor cores, the rest FFMA; launches counted
   by route; G in {1, 2, 8}, windows below, at and past S, soft-cap on
   and off, views of (B, S, H, D) memory) and through the autograd
   Function (one forward launch, the backward's three kernels); at the
   path's shapes (qwen3-0.6b 8 x 16 x 2048 x 128 causal; gemma2-9b 1 x 16
   x 8192 x 256, cap 50, window 4096 and global) with two runs bitwise
   equal, each timed beside its bound (10 D flop a live pair at the bf16
   peak), its plain version and, where no cap or window is set, autograd
   of ``scaled_dot_product_attention(is_causal=True)`` and the FFMA
   kernels on the same inputs through their C entry point (yardsticks).
   12.2: qwen3-0.6b at full width and depth, bf16 parameters, fp32
   moments, ``loss_chunks`` 8, 8 x 2048 synthetic tokens a step,
   ``TR_STEPS`` steps plain and as many with the rank-8 compression,
   through ``init_train_state`` and ``make_train_step``: the loss falls in
   both, every step's launches equal the accounting (``train_expected``),
   ``compress_ratio`` is the JAX package's 2384199680 / 41213952, ms a
   step, tokens/s, peak memory, and one step's profile each (whose
   backward kernels must be the route's: delta, dK/dV, dQ); then
   ``TR_REMAT_STEPS`` steps under ``remat_policy`` "full" (each layer
   recomputed whole) against the plain run's "minimal" (the weight GEMMs'
   outputs saved): the same losses bitwise, ms a step and peak memory of
   both, and fewer cuBLAS GEMM launches in "minimal"'s profiled step than
   in "full"'s (kernels named by ``GEMM_NAME``); then both timed in
   ``TR_REMAT_PAIRS`` pairs of steps in turns (``remat_turns``); the
   compression's sweeps at their eight shapes, each against its plain
   version and timed.  12.3: the
   runner with a failure planted before step 5 and a checkpoint every 4
   steps (qwen3's widths, 2 layers) resumes bitwise: every loss and the
   final state.  12.4: the fp32 smoke configs of the dense-attention
   text archs (gemma2-9b, qwen3-0.6b, starcoder2-15b, yi-6b),
   3 steps plain and 3 compressed at lr 5e-3 on the card and on the CPU
   from one state: every loss within 1e-4, each parameter tensor within
   1e-4 of its norm (not element by element: see ``train_card_vs_cpu``).  ``--only-training`` runs phases 1 and 12 alone.
13. the static contract checker and the tooling around the solver.
   13.1: ``repro_torch.analysis.run_all(device="cuda")``: every target
   (the driver's own block step on each backend, fp32 and bf16, the
   sketches and extractions, the faithful and fused deflation steps, the
   bf16 chain; the sharded ones in a child process on a world-1 NCCL
   group) runs once on the card and launches its kernels; the route
   census is printed, and it fails on any violation that is not
   allowlisted, and unless each A-traffic group (the kernels' own tally,
   ``ops.thread_a_bytes``) equals its operator's accounting.  13.2: the
   memory pass's peak estimate of one block step at
   65536 x 8192 (fp32, then its bf16 twin) beside
   ``torch.cuda.max_memory_allocated()`` around the step, within
   ``TOL_MEM_BYTES``, where an estimate blind to the step's own storages
   falls outside it.  13.3: ``python -m repro_torch.launch.svd_dryrun``
   (fake tensors, a fake group of world 256) printed as one
   ``{"svd_dryrun": {...}}`` line; in a full run also ``block/opt``'s
   bytes of A a step for the 262144 x 32768 per-node shard over
   ``PEAK_BYTES`` beside phase 3's measured seconds a step.  13.4: the
   five examples (``python -m repro_torch.examples.<name>``) on the
   card, started together with the dry run at the phase's start, each
   must exit 0; their seconds are printed.  ``--only-analysis`` runs
   phases 1 and 13 alone.
14. the other LM families, served at full width.  The recurrence
   kernels (``rglru_scan``, ``wkv6``) against their plain loops at
   ragged shapes (``REC_RAGGED``: T = 1, T = 4097, T at wkv6's chunk
   edges at each head size, R no multiple of 4, B = 1, with and without
   an initial state; ``REC_DECAYS``: wkv6's decays all below 1e-30 and
   all 1 - 2^-24; limits ``TOL_REC``: 1e-5 and 1e-4 of the output's max
   |value|; every state bitwise the plain loop's and every rerun bitwise
   its first run, or the phase fails), then at the prefill's shapes,
   (2, 4096, 4096) and (2, 4096, 32, 64), timed beside their byte bounds
   and plain versions; ``local_attention`` at the families' head
   layouts (MQA at D 256 with window 2048, grok-1's capped global layers,
   a group of 7, a group of 1 at D 64) against its plain version, phase
   7's per-element rule, timed beside its plain version and
   ``scaled_dot_product_attention`` (K/V repeated; a band mask where the
   window is shorter than the sequence, ``is_causal`` where not; none on
   the capped layer); each family's fp32 smoke config (llama4-scout's
   too) on the card against the CPU within ``TOL_CACHE``; then
   recurrentgemma-9b (38 layers, 2 x 4096 tokens, 16 decode steps),
   rwkv6-1.6b (24, 4096, 16), grok-1-314b (cut to 4 of 64 layers, 2048,
   8), llava-next-34b (cut to 16 of 60, 576 zero patch positions + 1024
   tokens, 8) and musicgen-large (48, 4 codebooks x 1024, 16), one at a
   time from seeded random weights: the launches of a prefill and of the
   decode steps (one attention an attention layer in the prefill, one
   recurrence a recurrent layer in both), finite logits and tokens in
   range, prefill seconds, decode ms a step, peak device memory, decode
   at position S against a prefill over S + 1 within ``TOL_CONSISTENCY``
   (grok-1 on a copy of its config with capacity factor E / k; its drops
   at the published 1.25 printed), and a profile of a prefill of the two
   recurrent models.  ``--only-lm-families`` runs phases 1 and 14
   alone.
15. training of the recurrent families.  15.1: the backward kernels of
   the recurrences (``rglru_scan_bwd``, ``wkv6_bwd``: ``csrc/rglru_scan.cu``
   and ``csrc/wkv6.cu``) against their plain reverse loops
   (``ref.rglru_scan_bwd_ref``, ``ref.wkv6_bwd_ref``) at ``REC_RAGGED``'s
   shapes, with and without an initial state (wkv6: and a given or an
   absent dS_T) and wkv6 at ``REC_DECAYS``' edges: RG-LRU's da, db, dh0
   and wkv6's dS0 bitwise, wkv6's other gradients within
   ``TOL_WKV6_BWD`` (1e-4 of each one's max |value|), every rerun
   bitwise; wkv6's backward also at its sub-chunk's edges (T = U - 1, U,
   U + 1 at each head size) and on one and two blocks; then at a training
   step's shapes (8, 2048, 4096) and (8, 2048, 32, 64), timed beside their
   bounds and plain loops, with wkv6's forward timed with and without its
   chunk starts, and wkv6's backward at every head size (8, 2048, H, hd)
   (``WKV6_BWD_SHAPES``) beside its bound, with its blocks an SM; the
   attention backward at recurrentgemma-9b's local layers' training shape
   (MQA, a group of 16 at D 256, window 2048) held element by element to
   its plain version with float64 sums (the fp32 one's reading beside).
   15.2: rwkv6-1.6b (24 layers) and recurrentgemma-9b (cut to 6 of 38
   layers, two groups: ``RT_MODELS``) at full width, bf16 parameters,
   fp32 moments, ``loss_chunks`` 8, 8 x 2048 synthetic tokens a step,
   ``RT_STEPS`` plain steps: the loss falls, every step's launches equal
   the accounting (a recurrent layer its recurrence twice and its
   backward kernel once, a local layer the attention twice and its
   backward's kernels once), ms a step, tokens/s, peak memory, and a
   profiled step (busy share, top kernels, the backward kernels'
   share); two compressed steps of rwkv6-1.6b (``compress_ratio`` the
   JAX package's 6335569920 / 24149248); each family at full width and
   2 layers stepped twice from one state, bitwise.  15.3: the fp32 smoke
   configs of the six other families (recurrentgemma, rwkv6, grok-1,
   llama4-scout, llava-next, musicgen) trained on the card and on the CPU
   as in 12.4 without the compression; with it, each step from the
   CPU's state on both, the loss and each compressed leaf's P Qn^T held
   to 1e-4 (``compressed_card_vs_cpu`` says why not the trajectory).
   ``--only-recurrent-training`` runs phases 1 and 15 alone.
16. The sharded LM (``make_train_step(cfg, tc, mesh)``: FSDP over
   ``data``, tensor parallelism over ``model``, explicit collectives in
   ``core/parallel.py``), on ``SL_RANKS`` gloo ranks sharing the card
   (``torchrun --standalone``, this script with ``--sharded-lm-rank DIR``
   as in 10.2; gloo through the host, not NCCL between cards).  16.1:
   qwen3-0.6b at full width, **cut to ``SL_LAYERS`` = 2 of 28 layers and
   ``SL_STEPS`` = 2 steps for the script's time**, on a (2, 2) data x
   model mesh, 8 x 2048 bigram tokens global, bf16, ``loss_chunks`` 8, held
   to the one-process steps the parent runs first on the same weights
   and batches (the first loss within ``TOL_SL_LOSS``, the parameters
   within ``TOL_SL_MATRICES`` / ``TOL_SL_PARAMS`` of their norm), the
   loss falls, ranks holding a shard hold the same bits, every step's
   collectives equal ``training/schedule.py``'s schedule on every rank,
   the attention's launches a step (forward twice a layer, the backward's
   three kernels once, on ``wgmma``); ms a step and the share inside
   collectives (each step with a sync on either side of each collective;
   the second step's), peak memory a rank.  16.2: the ten archs' fp32 smoke configs, one step each on the
   same ranks, within ``TOL_SL_SMOKE`` of the one-process step (the MoE
   configs of ``moe_by_shard``, the JAX package's per-shard MoE run in one
   process).  Then the attention forward (with ``lse``) and backward at
   a rank's local heads beside their bounds, plain versions and SDPA.
   16.3, compressed training across ranks (``optim/compression.py``'s
   power step on the ranks' shards, rank ``TR_RANK``, ``min_size``
   ``SC_MIN_SIZE``): the same model, ``SC_STEPS`` steps on a
   ``SC_MESH`` pod x data x model mesh (each pod its own rows' gradient
   and error buffers, only the factors and the uncompressed leaves
   crossing ``pod``) and one on ``SL_MESH``; the parent first writes
   one-process references (``sc_references``: the cross-pod step
   emulated pod by pod, ``sc_pod_step``) and each rank step starts from
   the parent's state, held one step at a time: the loss within
   ``TOL_SC_LOSS``, ``M_hat = P Qn^T`` (from the factors) within
   ``TOL_SC_HAT`` and each pod's error buffer within ``TOL_SC_ERR`` of
   ``||M||``; ``Q`` bitwise on every rank, replicas bitwise, the
   schedule exactly, the bytes across ``pod`` the schedule's; ms a step,
   share inside collectives, cross-pod bytes plain against compressed,
   peak memory a rank.  The sweeps at rank 0's shard shapes are timed as
   ``block_matvec/tf32x3[sharded compression]`` and
   ``block_rmatvec/tf32x3[sharded compression]``, launches from rank 0's
   16.3 steps.  16.4, sharded prefill and decode (``transformer.prefill``
   / ``decode_step`` of a model built with the mesh, on ``SL_MESH``; each
   rank its rows, its shards of the weights and of the caches, the KV
   ring's time axis over ``model``): qwen3-0.6b at full width and
   ``SL_LAYERS`` layers, an ``SS_BATCH`` x ``SS_PROMPT`` prompt into a
   cache of ``SS_MAX_SEQ`` positions and ``SS_STEPS`` decode steps;
   recurrentgemma-9b at full width, ``SS_RG_LAYERS`` layers (one rglru,
   rglru, local group; MQA, a group of 16 over one K/V head), its
   2048-slot ring full after the prompt and wrapped by ``SS_RG_STEPS``
   steps; the ten archs' fp32 smoke configs, prefill and
   ``SS_SMOKE_STEPS`` steps.  The parent runs each on one process first
   (``ss_references``; the MoE shard by shard) on the same weights and
   tokens, and every rank holds its rows' logits to them (bf16: max
   difference over max logit within ``TOL_SS_BF16``; fp32 within
   ``TOL_SL_SMOKE``); every prefill's and step's collectives equal
   ``prefill_collectives`` / ``decode_collectives``, ``local_attention``
   launches once an attention layer a prefill and never in a step, each
   rank's cache has ``cache_specs``' local shapes; prefill s, decode ms a
   step, share inside collectives, peak memory a rank, and 16.4's
   seconds.  ``--only-sharded-lm`` runs phases 1 and 16 alone.

Prints a ``{"kernels": [...]}`` line (each kernel's launches in the
run of its path, and its times; the block sweeps as ``<name>/tf32x3``
for the main path's fp32 solve, as ``<name>/wgmma`` for the bf16
solve's chains, as ``<name>/tf32x3_cpasync`` for the odd-width shard's
fp32 solve, timed at 262144 x 32767, and as ``<name>/wgmma_ld`` and
``<name>/wgmma_ld[odd lda]`` for the bf16 chains handed to ``ops`` at
65536 x 8190 and 65536 x 8191, launches from those chains; ``gram`` for the gram solve's 3xTF32 kernel and
``gram/wgmma`` for the bf16 one, launched once through ``ops``, both
timed at 262144 x 8192, ``gram/tf32x3_cpasync`` for the odd-width gram
solve's and ``gram/wgmma_ld`` for bf16 of those rows, timed at 262144 x
8191, ``gram/wgmma[trans]``, bf16 ``A A^T`` of the wide input, and
``gram/wgmma_ld[trans]``, the same of the wide input one column short), the
``nvidia-smi`` name and
power limit line again, and last ``{"ok": true, "device": {...}}``;
the CSR kernels as ``csr_matmat``, ``csr_rmatmat`` and
``csr_gram_chain`` (fp32 values; launches from the fp32 paper-share
solve) and the same with ``[bf16]`` (from the bf16 solve); before them an
``{"out_of_core": {...}}`` line with phase 8's numbers, a
``{"sparse": {...}}`` line with phase 9's and a ``{"sharded": {...}}``
line with phase 10's, a ``{"serving": {...}}`` line with phase 11's and
a ``{"training": {...}}`` line with phase 12's, an ``{"analysis":
{...}}`` line with phase 13's, an ``{"lm_families": {...}}`` line with
phase 14's, a ``{"recurrent_training": {...}}`` line with phase 15's, a
``{"sharded_lm": {...}}`` line with phase 16's; the recurrences as ``rglru_scan`` and ``wkv6``, launches
from phase 14's served models (prefill and decode), each with its
``share_of_bound`` (``bound_ms`` over ``ms``);
the sharded path's launches (10.1, one rank) as
``<kernel>/<route>[sharded]`` for the block solves and ``<kernel>[sharded
<method> faithful]`` / ``[sharded <method> fused]`` for the deflation
solves, beside the rows measured at the same shapes; the service's as
``<kernel>[/<route>][service <job>]``, each job's measured launches (and ``[service burst <dtype>, one
by one]`` for the bursts' standalone solves), beside the rows measured at
their shapes in phase 11; the training path's (phase 12.2) as
``local_attention_bwd/wgmma``, ``local_attention[training]`` (the forward with
its log-sum-exp), ``block_matvec/tf32x3[compression]`` and
``block_rmatvec/tf32x3[compression]`` (one step's eight sweeps, their
times summed); the recurrences' backward kernels as ``rglru_scan_bwd``
and ``wkv6_bwd``, launches from phase 15.2's training steps, timed at a
training step's shapes; the sharded LM's (16.1, rank 0's three steps) as
``local_attention_bwd/wgmma[sharded lm]`` and ``local_attention[sharded
lm]``, timed at a rank's local heads, and 16.4's prefills (rank 0) as
``local_attention[sharded serve]``, timed at the same shape (qwen3-0.6b's
prefill on a rank); and each phase's seconds.
Exits 2 without a CUDA device or without ``src/repro_torch`` beside this
script.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

SEED = 0
M, N, K = 262144, 32768, 32            # the main path's shape and rank
N_SPECTRUM = 64                        # s_i = 100 * 0.9**i, i < 64
NOISE = 1e-6                           # entry std; ||noise||_2 ~ 7e-4 << s_31
WIDE = (8192, 131072)                  # contiguous wide input
RERUN = (16384, 4096)
K_GRAMFREE, K_GRAM, K_WIDE = 16, 8, 4  # ranks of the deflation solves
N_GRAM = 8192                          # columns of the gram path's A
TOL_DEFLATION = 2e-3                   # sigma rtol, tests/test_tsvd.py:20
LM_ARCH, LM_SEED = "gemma2-9b", 0
LM_BATCH, LM_PROMPT, LM_TOKENS = 2, 8192, 32   # prompts, tokens, decode steps
TOL_ATTN_FP32 = 1e-4                   # tests/test_kernels.py:208
ATOL_ATTN_BF16 = 1e-5                  # 10x the fp32 kernel-vs-plain errors
# decode vs prefill, from readings on an H100: sound 2.07e-2; planted
# faults: position off by one 1.67e-1, cache empty 1.41, one skipped slot
# 2.34e-2 (within noise at random weights, so not claimed)
TOL_CONSISTENCY = 5e-2
FAULTS_SEEN = ("position off by one", "cache empty")
# the fp32 smoke config of gemma2-9b served on the card and on the CPU from
# the same seed-0 weights: a prefill of CACHE_PROMPT tokens and CACHE_STEPS
# decode steps, which wrap the local layers' ring of `window` (8) slots
# one and a half times; every step's logits and every cache tensor
# compared.  Readings on an H100: sound 5.24e-7 (fp32 sums in other
# orders), the last prompt position's slot skipped 2.33e-1
CACHE_PROMPT, CACHE_STEPS = 12, 12
TOL_CACHE = 1e-4
SLAB = 16384                           # rows per chunk of the plain versions
# Limits of kernel vs plain: the same (bf16-rounded) operands summed in
# fp32 in another order.  The bf16 chain rounds its fp32 intermediate to
# bf16; where kernel and plain land on either side of a rounding
# boundary that entry moves by a whole bf16 step (2^-8 relative).
TOL = {"float32": 1e-5, "bfloat16": 1e-5}
TOL_CHAIN_BF16 = 1e-3
# phase 13.2: the memory pass's peak estimate of a block step against
# max_memory_allocated() around it.  A and the state are live on both
# sides, so what is compared is the step's own peak (readings on an H100
# at MEM_SHAPE: 34.6 MB fp32, 17.8 MB bf16).  The estimate sees every
# storage made through the dispatcher; it cannot see what is allocated
# below it (cuSOLVER's QR workspace, cuBLAS's) or the allocator's
# rounding of each block to 512 bytes.  Readings: estimate - measured 0
# bytes fp32, -67,584 bf16.  1 MiB is 15 times the larger reading and
# under a sixteenth of the smaller step's own peak; the phase also shows
# that an estimate blind to the step's own storages falls outside it
MEM_SHAPE = (65536, 8192)
TOL_MEM_BYTES = 1 << 20
EXAMPLES = ("quickstart", "unified_api", "svd_service", "chaos_demo",
            "compress_model")


def gram_tol(r: int) -> float:
    """Limit of the gram kernels against their plain version for a
    reduction of length ``r``: each entry is summed in one fixed sequence
    (no split of the reduction, so no atomics), which rounds to about
    sqrt(r) * 2^-24 relative (a sequential fp32 sum of r terms; the
    3xTF32 kernel's of r / 32 stage sums, the bf16 one's of r / 256),
    where the plain version (cuBLAS) rounds at least as much; 4 sqrt(r)
    2^-24, and at least the 1e-5 of the other kernels (1.2e-4 at r =
    262144)."""
    return max(1e-5, 4 * r ** 0.5 * 2.0 ** -24)


# gram_tol cannot see plain TF32: on signed data at the gram path's aspect
# (m / n = 32) plain TF32 reads 5.12e-5 over the whole product, inside
# gram_tol (6.1e-5 at m = 65536), but 2.94e-4 over the off-diagonal
# entries, whose sums cancel (readings on an H100, 65536 x 2048).  Limit of
# that second reading (gram_offdiag_err), set between the sound kernels'
# (3xTF32 <= 2.8e-6, bf16 on wgmma 2.6e-6, both at 262144 x 8192) and the
# planted faults' (plain TF32 2.94e-4; unpromoted sums 4.6e-4 in 3xTF32,
# 7.6e-5 and 3.9e-4 on signed and |N(0, 1)| data in bf16).
TOL_GRAM_OFFDIAG = 4e-5
GRAM_FAULT = (65536, 2048)             # planted gram faults, the path's aspect


def gram_offdiag_err(torch, got, want) -> float:
    """The relative Frobenius error of ``got`` against ``want`` over the
    entries off the main diagonal alone (of a product or of a slice of
    its rows); 0 where there are none."""
    d, w = got - want, want.clone()
    d.diagonal().zero_()
    w.diagonal().zero_()
    den = float(torch.linalg.norm(w))
    return float(torch.linalg.norm(d)) / den if den > 0 else 0.0
# H100 SXM data sheet: HBM3 rate, fp32 (non-tensor), tf32 and bf16 dense
# peaks
PEAK_BYTES = 3.35e12
PEAK_OPS = {"float32": 67e12, "tfloat32": 495e12, "bfloat16": 989e12}
TPU_KERNEL = "src/repro/kernels/block_matvec.py"
REPLACES = {"block_matvec": f"{TPU_KERNEL}:81",
            "block_rmatvec": f"{TPU_KERNEL}:127",
            "block_gram_chain": f"{TPU_KERNEL}:146",
            "matvec": "src/repro/kernels/deflate_matvec.py:55",
            "deflate_rmatvec": "src/repro/kernels/deflate_matvec.py:127",
            "gram": "src/repro/kernels/gram.py:84",
            "local_attention": "src/repro/kernels/local_attn.py:104"}
TC_SOURCE = "src/repro_torch/csrc/block_matvec_tc.cu"
TF32_SOURCE = "src/repro_torch/csrc/block_matvec_tf32.cu"
ODD = (65536, 8190)                    # rows no tensor map describes
ODD_LDA = (65536, 8191)                # bf16: every other row 2 bytes off
ODD_SHARD = (M, N - 1)                 # the paper's shard one column short
RERUN_ODD = (RERUN[0], RERUN[1] - 1)
SOURCES = {"matvec": "src/repro_torch/csrc/deflate_matvec.cu",
           "deflate_rmatvec": "src/repro_torch/csrc/deflate_matvec.cu",
           "gram": "src/repro_torch/csrc/gram_tf32.cu",
           "gram/tf32x3_cpasync": "src/repro_torch/csrc/gram_tf32.cu",
           "gram/wgmma": "src/repro_torch/csrc/gram_bf16.cu",
           "gram/wgmma_ld": "src/repro_torch/csrc/gram_bf16.cu",
           "gram/wgmma[trans]": "src/repro_torch/csrc/gram_bf16.cu",
           "gram/wgmma_ld[trans]": "src/repro_torch/csrc/gram_bf16.cu",
           "local_attention": "src/repro_torch/csrc/local_attn.cu"}
LIBRARY = {"matvec": "torch.mv(A, v)",
           "deflate_rmatvec": "torch.mv(A.mT, Xv - U @ SVtv) + U.mT @ Xv "
                              "(two calls)",
           "gram": "torch.mm(A.mT, A) (TF32 off)",
           "gram/tf32x3_cpasync": "torch.mm(A.mT, A) (TF32 off)"}
# bf16 gram's library call: torch.mm with out_dtype=torch.float32 (bf16 in,
# fp32 sums and out: the same function), set by bf16_mm where the card's
# torch takes out_dtype; else the bf16-out torch.mm, a time yardstick only
BF16_GRAM = ("gram/wgmma", "gram/wgmma_ld", "gram/wgmma[trans]",
             "gram/wgmma_ld[trans]")


def bf16_mm(torch, dev):
    """``torch.mm`` of bf16 operands with fp32 sums and output where this
    torch takes ``out_dtype`` (``aten::mm.dtype``), else bf16 out; and
    the label that says which."""
    x = torch.ones((16, 16), dtype=torch.bfloat16, device=dev)
    try:
        torch.mm(x, x, out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        return (lambda a, b: torch.mm(a, b),
                "torch.mm in bf16 out: this torch has no out_dtype; a time "
                "yardstick only")
    return (lambda a, b: torch.mm(a, b, out_dtype=torch.float32),
            "torch.mm(..., out_dtype=torch.float32)")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def pick(t_bytes: float, t_ops: float) -> tuple:
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gram_flop(m: int, n: int) -> int:
    """The symmetric schedule's m*n*(n+1) flop of ``gram``: each of the
    n(n+1)/2 distinct entries is a length-m dot product."""
    return m * n * (n + 1)


def deflation_bound(name: str, m: int, n: int, k: int = 0) -> tuple:
    """Least time on an H100 SXM for the deflation kernels: each input
    read once and each output written once over the memory rate, the flop
    over the fastest rate that keeps the result: ``matvec`` and
    ``deflate_rmatvec`` at the fp32 (non-tensor) peak (a matrix-vector
    product gains nothing from the tensor cores), fp32 ``gram`` as
    3xTF32, three TF32 products at the TF32 peak (its FFMA figure, at the
    fp32 peak, is printed beside it), bf16 ``gram`` (``gram/wgmma``,
    ``gram/wgmma_ld``) at the bf16 peak (its products are exact in
    fp32)."""
    if name == "matvec":
        nbytes, flop = 4 * (m * n + n + m), 2 * m * n
    elif name == "deflate_rmatvec":
        nbytes = 4 * (m * n + m * k + m + k + n + k)
        flop = 2 * m * n + 4 * m * k
    elif name == "gram":
        nbytes = 4 * (m * n + n * n)
        return pick(nbytes / PEAK_BYTES * 1e3,
                    3 * gram_flop(m, n) / PEAK_OPS["tfloat32"] * 1e3)
    else:       # bf16 gram: products exact in fp32, fp32 sums (bf16 cores)
        nbytes = 2 * m * n + 4 * n * n
        return pick(nbytes / PEAK_BYTES * 1e3,
                    gram_flop(m, n) / PEAK_OPS["bfloat16"] * 1e3)
    return pick(nbytes / PEAK_BYTES * 1e3, flop / PEAK_OPS["float32"] * 1e3)


def bound(name: str, m: int, n: int, k: int, dtype: str,
          route: str) -> tuple:
    """Least time for the function on an H100 SXM by ``route``: A and the
    skinny input read once in ``dtype``, the fp32 output written once,
    over the memory rate; 2*m*n*k flop per product over the peak for
    ``dtype`` (bf16 on the bf16 tensor cores; on the ``tf32x3`` and
    ``tf32x3_cpasync`` routes three TF32 products at the TF32 peak).  The chain's bound counts A once: a one-read fusion
    is possible."""
    isz = 2 if dtype == "bfloat16" else 4
    skinny_in, out, products = {"block_matvec": (n, m, 1),
                                "block_rmatvec": (m, n, 1),
                                "block_gram_chain": (n, n, 2)}[name]
    nbytes = m * n * isz + skinny_in * k * isz + out * k * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    if route.startswith("tf32x3"):
        products, dtype = 3 * products, "tfloat32"
    t_ops = products * 2 * m * n * k / PEAK_OPS[dtype] * 1e3
    return pick(t_bytes, t_ops)


# ---------------------------------------------------------------------------
# plain versions in row slabs (the bf16 upcast of a whole A would need
# another 34 GB); each slab is the plain version of ref.py
# ---------------------------------------------------------------------------

def plain_matvec(torch, ref, A, Q, sd):
    return torch.cat([ref.block_matvec_ref(A[r:r + SLAB], Q, sd)
                      for r in range(0, A.shape[0], SLAB)])


def plain_rmatvec(torch, ref, A, Y, sd):
    Z = torch.zeros((A.shape[1], Y.shape[1]), dtype=torch.float32,
                    device=A.device)
    for r in range(0, A.shape[0], SLAB):
        Z += ref.block_rmatvec_ref(A[r:r + SLAB], Y[r:r + SLAB], sd)
    return Z


def plain_chain(torch, ref, A, X, sd, trans=False):
    if trans:
        return plain_matvec(torch, ref, A, plain_rmatvec(torch, ref, A, X,
                                                         sd), sd)
    return plain_rmatvec(torch, ref, A, plain_matvec(torch, ref, A, X, sd),
                         sd)


def sweep_rows(torch, ops, ref, bm, A, Q, Ym, sd) -> dict:
    """The block sweeps of ``ops`` on ``A`` (fp32, taken in ``sd``) with
    k = Q.shape[1], each against its plain version (fail beyond its
    limit), with kernel, plain, ``torch.matmul`` (a yardstick only) and
    bound times and the route that ran it; one row a sweep.  Launches
    here are comparisons: the caller reads the path's counts before."""
    m, n = A.shape
    k = Q.shape[1]
    As = A if sd == "float32" else A.to(torch.bfloat16)
    Qs, Ys = Q.to(As.dtype), Ym.to(As.dtype)
    fns = {
        "block_matvec": (
            lambda: ops.block_matvec(As, Q),
            lambda: plain_matvec(torch, ref, As, Q, sd),
            lambda: torch.matmul(As, Qs)),
        "block_rmatvec": (
            lambda: ops.block_rmatvec(As, Ym),
            lambda: plain_rmatvec(torch, ref, As, Ym, sd),
            lambda: torch.matmul(As.mT, Ys)),
        "block_gram_chain": (
            lambda: ops.block_gram_chain(As, Q),
            lambda: plain_chain(torch, ref, As, Q, sd),
            lambda: torch.linalg.multi_dot([As.mT, As, Qs])),
    }
    rows = {}
    for name, (kern, plain, lib) in fns.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        e = rel_err(torch, got, want)
        tol = TOL_CHAIN_BF16 if (sd == "bfloat16" and
                                 name == "block_gram_chain") else TOL[sd]
        if not (bool(torch.isfinite(got).all()) and e <= tol):
            fail(f"{name} {sd} at {(m, n, k)}: rel err {e} > {tol}")
        row = {
            "shape": [m, n, k],
            "max_abs_err": float((got - want).abs().max()),
            "rel_err": e, "limit": tol,
            "ms": time_ms(torch, kern, 5),
            "plain_ms": time_ms(torch, plain, 2),
            "library_ms": time_ms(torch, lib, 3),
        }
        row["route"] = bm.route(As, k)
        row["bound_ms"], row["bound_by"] = bound(name, m, n, k, sd,
                                                 row["route"])
        rows[name] = row
        print(f"  {name:16s} {sd:8s} ({row['route']}) {m}x{n} k={k}: "
              f"rel err {e:.2e} "
              f"(limit {tol:.0e}), kernel {row['ms']:.2f} ms, plain "
              f"{row['plain_ms']:.2f} ms, torch.matmul "
              f"{row['library_ms']:.2f} ms, bound "
              f"{row['bound_ms']:.2f} ms ({row['bound_by']})")
        del got, want
    return rows


def wgmma_ld_rows(torch, ops, ref, bm, planted, X, Q, Y, counts) -> dict:
    """bf16 of ``X`` (fp32, m x n) handed to ``ops`` directly with rows no
    tensor map describes, ``wgmma_ld``'s path: one chain through ``ops``,
    whose launches (all on ``wgmma_ld``, or fail) go into ``counts`` by
    (sweep, shape); then ``sweep_rows`` in bf16; then each sweep's kernel
    timed beside its staging-only build (no products: what the copies of
    A cost alone), both through ``block_matvec``'s binding.  Returns the
    rows by sweep."""
    m, n = X.shape
    Ab = X.to(torch.bfloat16)
    ops.reset_launches()
    ops.block_gram_chain(Ab, Q)
    torch.cuda.synchronize()
    launched = {n_: c for n_, c in ops.launches.items() if c}
    routes = {n_: c for n_, c in ops.route_launches.items() if c}
    print(f"bf16 {m}x{n} (rows of {2 * n} bytes) through "
          f"ops.block_gram_chain: launches {launched} (by route {routes})")
    if routes != {"block_matvec/wgmma_ld": 1, "block_rmatvec/wgmma_ld": 1}:
        fail(f"bf16 {(m, n)}: launches by route {routes}, want wgmma_ld")
    for name, c in launched.items():
        counts[(name, (m, n))] = c
    rows = sweep_rows(torch, ops, ref, bm, X, Q, Y, "bfloat16")
    for name, row in rows.items():
        if row["route"] != "wgmma_ld":
            fail(f"{name} bf16 at {(m, n)}: route {row['route']}, not "
                 f"wgmma_ld")
    Qb, Yb = Q.to(torch.bfloat16), Y.to(torch.bfloat16)
    staging = planted[("block_matvec_tc", "REPRO_STAGING_ONLY")]
    for name, fn in (
            ("block_matvec",
             lambda: bm.block_matvec_cuda(Ab, Qb, "wgmma_ld")),
            ("block_rmatvec",
             lambda: bm.block_rmatvec_cuda(Ab, Yb, "wgmma_ld"))):
        row = rows[name]
        row["ms_binding"] = time_ms(torch, fn, 5)
        row["ms_staging_only"] = planted_run(
            bm, "block_matvec_tc", staging, lambda: time_ms(torch, fn, 5))
        print(f"  {name:16s} bf16 (wgmma_ld) {m}x{n}: the kernel through "
              f"its binding {row['ms_binding']:.3f} ms, its staging alone "
              f"(no products) {row['ms_staging_only']:.3f} ms, bound "
              f"{row['bound_ms']:.3f} ms")
    del Ab, Qb, Yb
    return rows


def rel_err(torch, got, want) -> float:
    return float(torch.linalg.norm(got - want) /
                 (torch.linalg.norm(want) + 1e-30))


def spectral_matrix(torch, m, n, seed, dev):
    """``U diag(s) V^T + NOISE * G`` on the card, built in row chunks
    from a seeded generator; returns (A, s)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    s = (100.0 * 0.9 ** torch.arange(N_SPECTRUM, dtype=torch.float64)
         ).to(torch.float32).to(dev)
    U = torch.linalg.qr(torch.randn(m, N_SPECTRUM, generator=g,
                                    device=dev)).Q
    V = torch.linalg.qr(torch.randn(n, N_SPECTRUM, generator=g,
                                    device=dev)).Q
    A = torch.empty((m, n), dtype=torch.float32, device=dev)
    step = max(1, (1 << 28) // n)                 # 1 GiB of fp32 per chunk
    for r in range(0, m, step):
        A[r:r + step] = (U[r:r + step] * s) @ V.mT
        A[r:r + step].add_(torch.randn((min(step, m - r), n), generator=g,
                                       device=dev), alpha=NOISE)
    return A, s


def check(torch, label: str, got, want, tol: float) -> float:
    """Fail unless ``got`` is a finite fp32 tensor of ``want``'s shape
    within ``tol`` relative Frobenius error of it; return the error."""
    if got.dtype != torch.float32 or got.shape != want.shape:
        fail(f"{label}: got {got.dtype} {tuple(got.shape)}, want "
             f"{tuple(want.shape)}")
    e = rel_err(torch, got, want)
    if not (bool(torch.isfinite(got).all()) and e <= tol):
        fail(f"{label}: rel err {e} > {tol}")
    return e


def padded_views(torch, ops, ref, bm, g, dev) -> float:
    """The block sweeps on (m, n) views of rows ``ld`` apart, at a base
    ``offset`` elements into an allocation of one row more, every element
    outside the view NaN (a kernel that reads past a row's n-th element
    returns NaN): fp32 on both 3xTF32 routes (cp.async of 4 and of 8
    bytes), bf16 as ``DenseOperator`` copies it (rows padded to whole 16
    bytes: ``wgmma``) and on ``wgmma_ld`` at a base a tensor map cannot
    take (2 bytes off: registers), an odd row stride (every other row by
    registers) and an odd n in rows of even stride (4-byte copies, the
    last word half inside the row); each against its plain version and
    on the route it should take.
    Returns the worst error as a share of its limit."""
    worst = 0.0
    for (m, n, k, ld, offset, sd, route) in [
            (3001, 1021, 32, 1024, 1, "float32", "tf32x3_cpasync"),
            (3001, 1021, 40, 1026, 2, "float32", "tf32x3_cpasync"),
            (3001, 1021, 7, 1027, 3, "float32", "tf32x3_cpasync"),
            (3001, 1021, 32, 1024, 0, "float32", "tf32x3"),
            (4097, 515, 40, 520, 0, "bfloat16", "wgmma"),
            (4097, 515, 40, 520, 1, "bfloat16", "wgmma_ld"),
            (4097, 515, 40, 517, 0, "bfloat16", "wgmma_ld"),
            (4097, 515, 40, 518, 0, "bfloat16", "wgmma_ld")]:
        dt = getattr(torch, sd)
        flat = torch.full((offset + (m + 1) * ld,), float("nan"), dtype=dt,
                          device=dev)
        A = flat[offset:offset + m * ld].view(m, ld)[:, :n]
        A.copy_(torch.randn((m, n), generator=g, device=dev))
        Q = torch.randn((n, k), generator=g, device=dev)
        Y = torch.randn((m, k), generator=g, device=dev)
        if bm.route(A, k) != route:
            fail(f"{sd} view {(m, n)} rows {ld} apart at offset {offset}: "
                 f"route {bm.route(A, k)}, want {route}")
        ops.reset_launches()
        chain_tol = TOL_CHAIN_BF16 if sd == "bfloat16" else TOL[sd]
        cases = [("block_matvec", ops.block_matvec(A, Q),
                  ref.block_matvec_ref(A, Q, sd), TOL[sd]),
                 ("block_rmatvec", ops.block_rmatvec(A, Y),
                  ref.block_rmatvec_ref(A, Y, sd), TOL[sd]),
                 ("block_gram_chain", ops.block_gram_chain(A, Q),
                  ref.block_gram_chain_ref(A, Q, sd), chain_tol)]
        torch.cuda.synchronize()
        ran = {n_: c for n_, c in ops.route_launches.items() if c}
        if ran != {f"block_matvec/{route}": 2, f"block_rmatvec/{route}": 2}:
            fail(f"{sd} view {(m, n)}: route {route}, launches {ran}")
        for name, got, want, tol in cases:
            e = check(torch, f"{name} {sd} view {(m, n, k)} rows {ld} apart "
                      f"at offset {offset}", got, want, tol)
            worst = max(worst, e / tol)
            print(f"  {name:16s} {sd:8s} ({route}) view m={m} n={n} k={k} "
                  f"rows {ld} apart, offset {offset}: rel err {e:.2e} "
                  f"(limit {tol:.0e})")
        del flat, A
    return worst


def gram_readings(torch, ops, ref, gm, As, label: str) -> float:
    """``gram`` of ``As`` (fp32 or bf16, contiguous or a view of wider
    rows), both layouts, symmetric and full, against its plain version:
    the route that ran (from the route launch counts) is
    ``gram.route``'s, B is exactly symmetric, the whole product within
    ``gram_tol`` and its off-diagonal entries within
    ``TOL_GRAM_OFFDIAG``.  Returns the worst reading as a share of its
    limit."""
    worst = 0.0
    m, n = As.shape
    which = gm.route(As)
    sd = str(As.dtype).split(".")[1]
    for trans in (False, True):
        want = ref.gram_ref(As, trans)
        tol = gram_tol(n if trans else m)
        for sym in (True, False):
            ops.reset_launches()
            got = ops.gram(As, symmetric=sym, trans=trans)
            torch.cuda.synchronize()
            ran = {n_: c for n_, c in ops.route_launches.items() if c}
            lab = (f"gram[{sd},{'sym' if sym else 'full'}"
                   f"{',trans' if trans else ''}] ({which}) {label}")
            if ran != {f"gram/{which}": 1}:
                fail(f"{lab}: launches by route {ran}")
            if not torch.equal(got, got.mT):
                fail(f"{lab}: B is not symmetric")
            e = check(torch, lab, got, want, tol)
            od = gram_offdiag_err(torch, got, want)
            print(f"  {lab}: rel err {e:.2e} (limit {tol:.1e}), off the "
                  f"diagonal {od:.2e} (limit {TOL_GRAM_OFFDIAG:.0e})")
            if outside(od, TOL_GRAM_OFFDIAG):
                fail(f"{lab}: off-diagonal rel err {od} > "
                     f"{TOL_GRAM_OFFDIAG}")
            worst = max(worst, e / tol, od / TOL_GRAM_OFFDIAG)
            del got
    return worst


def deflation_ragged(torch, ops, ref, gm, g, dev) -> float:
    """The deflation kernels against their plain versions at ragged
    shapes, both layouts, and ``gram`` also on views whose row padding
    is NaN (a kernel that reads past a row's n-th element returns NaN);
    returns the worst error as a share of its limit."""
    worst = 0.0
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
    # k = 1030: U^T Xv summed in two column chunks of U
    for (m, n, k) in [(1000, 300, 7), (4097, 515, 1), (257, 4100, 16),
                      (40000, 96, 3), (33, 1, 2), (3000, 2051, 5),
                      (3000, 2051, 1030)]:
        A = rnd(m, n)
        v, u, c = rnd(n), rnd(m), rnd(k)
        U, V = rnd(m, k), rnd(n, k)
        cases = [("matvec", ops.matvec(A, v), ref.matvec_ref(A, v), 1e-5),
                 ("matvec[trans]", ops.matvec(A, u, trans=True),
                  ref.matvec_ref(A, u, True), 1e-5)]
        for lab, got, want in (
                ("deflate_rmatvec", ops.deflate_rmatvec(A, U, u, c),
                 ref.deflate_rmatvec_ref(A, U, u, c)),
                ("deflate_rmatvec[trans]",
                 ops.deflate_rmatvec(A, V, v, c, trans=True),
                 ref.deflate_rmatvec_ref(A, V, v, c, True))):
            cases += [(lab + ".t13", got[0], want[0], 1e-5),
                      (lab + ".utx", got[1], want[1], 1e-5)]
        torch.cuda.synchronize()
        for lab, got, want, tol in cases:
            e = check(torch, f"{lab} m={m} n={n} k={k}", got, want, tol)
            worst = max(worst, e / tol)
            print(f"  {lab:30s} m={m} n={n} k={k}: rel err {e:.2e} "
                  f"(limit {tol:.1e})")
        del cases
        if k != 1030:                 # gram does not depend on k
            for sd in ("float32", "bfloat16"):
                worst = max(worst, gram_readings(
                    torch, ops, ref, gm, A.to(getattr(torch, sd)),
                    f"m={m} n={n}"))
    # views of rows ld apart at a base `offset` elements into an allocation
    # of one row more, NaN outside the view: fp32 cp.async of 4 and 8
    # bytes and TMA; bf16 "wgmma_ld" with a base 2 bytes off (every row by
    # registers), an odd lda (every other row), an even lda not a multiple
    # of 8 (cp.async of 4 and 8 bytes), and "wgmma" (TMA)
    for (m, n, ld, offset, sd) in [(3001, 1021, 1024, 1, "float32"),
                                   (3001, 1021, 1026, 2, "float32"),
                                   (3001, 1021, 1024, 0, "float32"),
                                   (3001, 1021, 1024, 1, "bfloat16"),
                                   (3001, 1021, 1023, 0, "bfloat16"),
                                   (3001, 1021, 1026, 0, "bfloat16"),
                                   (3001, 1024, 1032, 0, "bfloat16")]:
        flat = torch.full((offset + (m + 1) * ld,), float("nan"),
                          dtype=getattr(torch, sd), device=dev)
        A = flat[offset:offset + m * ld].view(m, ld)[:, :n]
        A.copy_(rnd(m, n))
        worst = max(worst, gram_readings(
            torch, ops, ref, gm, A,
            f"view m={m} n={n} rows {ld} apart at offset {offset}"))
        del flat, A
    return worst


def time_kernel(torch, name, kern, plain, lib, reps, tol, bnd,
                offdiag=False) -> dict:
    """Check the kernel at a path shape and time it, its plain version
    and its library yardstick (``reps`` runs each, CUDA events; ``lib``
    None where no one PyTorch call computes the function).  ``offdiag``:
    ``gram``'s second reading, its off-diagonal entries within
    ``TOL_GRAM_OFFDIAG``."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    if isinstance(got, tuple):
        errs = [check(torch, name, a, b, tol) for a, b in zip(got, want)]
        e = max(errs)
        mae = max(float((a - b).abs().max()) for a, b in zip(got, want))
    else:
        e = check(torch, name, got, want, tol)
        mae = float((got - want).abs().max())
    row = {"max_abs_err": mae, "rel_err": e, "limit": tol}
    if offdiag:
        row["offdiag_err"] = gram_offdiag_err(torch, got, want)
        if outside(row["offdiag_err"], TOL_GRAM_OFFDIAG):
            fail(f"{name}: off-diagonal rel err {row['offdiag_err']} > "
                 f"{TOL_GRAM_OFFDIAG}")
    del got, want
    row.update(ms=time_ms(torch, kern, reps),
               plain_ms=time_ms(torch, plain, reps),
               library_ms=None if lib is None else time_ms(torch, lib, reps))
    row["bound_ms"], row["bound_by"] = bnd
    print(f"  {name:16s}: rel err {e:.2e} (limit {tol:.0e})" + (
              f", off the diagonal {row['offdiag_err']:.2e} (limit "
              f"{TOL_GRAM_OFFDIAG:.0e})" if offdiag else "")
          + f", kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
          f"library " + ("-" if lib is None else
                         f"{row['library_ms']:.3f} ms")
          + f" ({LIBRARY[name]}), bound {row['bound_ms']:.3f} ms "
          f"({row['bound_by']})")
    return row


def float64_reading(torch, ops, ref, Xb, rows=256) -> dict:
    """Rows [0, rows) of ``Xb^T Xb`` in float64 against the kernel's and
    the plain version's (cuBLAS fp32): which of the two sums rounds
    more, since both are held to each other."""
    X64 = Xb.double()
    exact = X64[:, :rows].mT @ X64
    del X64
    got = ops.gram(Xb)[:rows].double()
    X32 = Xb.float()
    plain = (X32[:, :rows].mT @ X32).double()
    del X32
    err = {lab: float(torch.linalg.norm(B - exact) / torch.linalg.norm(exact))
           for lab, B in (("kernel", got), ("plain", plain))}
    print(f"  bf16 gram rows 0..{rows - 1} against a float64 product: "
          f"kernel {err['kernel']:.2e}, plain version (cuBLAS fp32) "
          f"{err['plain']:.2e}")
    return err


def bf16_gram_row(torch, ops, ref, X, name, mm, trans=False) -> tuple:
    """bf16 ``gram`` of ``X`` cast to bf16 (``A^T A``; ``A A^T`` with
    ``trans``): once through ``ops`` with the launch counts set to 0 just
    before and read just after (one launch, on the route ``name`` names,
    B exactly symmetric), then checked against its plain version and
    timed beside it and ``mm``'s library call.  Returns (the row, the
    launches, the bf16 copy)."""
    Xb = X.to(torch.bfloat16)
    m, n = Xb.shape
    which = name.split("/")[1].split("[")[0]
    ops.reset_launches()
    B = ops.gram(Xb, trans=trans)
    torch.cuda.synchronize()
    ran = {n_: c for n_, c in ops.route_launches.items() if c}
    print(f"  bf16 gram {m}x{n}{' (A A^T)' if trans else ''} through ops: "
          f"launches by route {ran}")
    if ran != {f"gram/{which}": 1} or not torch.equal(B, B.mT):
        fail(f"bf16 gram of {m}x{n} (trans={trans}): launches by route "
             f"{ran}, want {which}; B exactly symmetric "
             f"{torch.equal(B, B.mT)}")
    del B
    r, edge = (n, m) if trans else (m, n)
    row = time_kernel(
        torch, name, lambda: ops.gram(Xb, trans=trans),
        lambda: ref.gram_ref(Xb, trans),
        (lambda: mm(Xb, Xb.mT)) if trans else (lambda: mm(Xb.mT, Xb)), 2,
        gram_tol(r), deflation_bound(name, r, edge), offdiag=True)
    return row, ran[f"gram/{which}"], Xb


def staging_ld(torch, gm, planted, row, Xb, trans=False) -> None:
    """bf16 ``gram`` of ``Xb`` on ``wgmma_ld`` from the build with no
    products (``-DREPRO_STAGING_ONLY``: the copies, the pushes between the
    cluster's blocks and the barriers alone), timed into ``row`` beside
    the kernel's time."""
    row["ms_repro_staging_only"] = planted_run(
        gm, "gram_bf16", planted[("gram_bf16", "REPRO_STAGING_ONLY")],
        lambda: time_ms(torch, lambda: gm.gram_cuda(Xb, "wgmma_ld",
                                                    trans=trans), 2))
    m, n = Xb.shape
    print(f"  bf16 gram {m}x{n}{' (A A^T)' if trans else ''} on wgmma_ld: "
          f"its staging alone (no products): "
          f"{row['ms_repro_staging_only']:.3f} ms; the kernel "
          f"{row['ms']:.3f} ms")


def padded_yardstick(torch, ops, gm, Xb) -> None:
    """Printed only, not a route: what ``Xb`` (bf16, rows no tensor map
    describes) would cost copied into rows padded to a multiple of 8
    elements and read by the ``wgmma`` route (TMA multicast), the copy
    and the kernel timed apart and together."""
    m, n = Xb.shape
    P = torch.empty((m, (n + 7) // 8 * 8), dtype=torch.bfloat16,
                    device=Xb.device)
    view = P[:, :n]
    view.copy_(Xb)
    if gm.route(view) != "wgmma":
        fail(f"padded copy of {m}x{n}: route {gm.route(view)}")
    t_copy = time_ms(torch, lambda: view.copy_(Xb), 2)
    t_gram = time_ms(torch, lambda: ops.gram(view), 2)
    t_both = time_ms(torch, lambda: (view.copy_(Xb), ops.gram(view)), 2)
    print(f"  yardstick (printed only, not a route): a padded copy of the "
          f"{m}x{n} bf16 A ({t_copy:.3f} ms) read by wgmma "
          f"({t_gram:.3f} ms): {t_both:.3f} ms together")
    del P, view


def deflation_solve(torch, repro_torch, ops, X, k, method, label, s,
                    table=None, gram_route="tf32x3"):
    """One deflation solve through ``repro_torch.svd``, held to the
    prescribed spectrum, to the pass accounting and (``method="gram"``)
    to ``gram_route``, the route of the engine's residual (a fresh
    contiguous fp32 copy of ``X``'s shape); returns the launch counts of
    its run."""
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = repro_torch.svd(X, k, method=method)
    counts = {n: c for n, c in ops.launches.items() if c}
    routes = {n: c for n, c in ops.route_launches.items() if c}
    it = [int(i) for i in res.iters]
    err = float((res.S.double().cpu() / s[:k].double().cpu() - 1)
                .abs().max())
    print(f"{label}: iters per rank {it} (sum {sum(it)}), passes_over_A "
          f"{res.passes_over_A}, bytes_per_pass {res.bytes_per_pass}, "
          f"converged {res.converged}, wall_time_s {res.wall_time_s:.3f}, "
          f"launches {counts} (by route {routes}), max sigma rel err "
          f"{err:.2e} (limit {TOL_DEFLATION:.0e}), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    if method == "gramfree":
        want = {"matvec": sum(it) + k, "deflate_rmatvec": sum(it)}
        passes, want_routes = 3 * sum(it) + k, {}
    else:
        want, passes = {"gram": k, "matvec": k}, 3 * k
        want_routes = {f"gram/{gram_route}": k}
    if counts != want:
        fail(f"{label}: launches {counts}, pass accounting implies {want}")
    if routes != want_routes:
        fail(f"{label}: launches by route {routes}, want {want_routes}")
    if res.passes_over_A != passes or res.backend != "dense" \
            or res.bytes_moved is not None:
        fail(f"{label}: passes {res.passes_over_A} (want {passes}), "
             f"backend {res.backend}")
    if not (res.converged and err <= TOL_DEFLATION
            and bool(torch.isfinite(res.U).all())
            and bool(torch.isfinite(res.V).all())):
        fail(f"{label}: not converged to the prescribed sigma")
    if table is not None:           # kernel time x launches vs wall time
        kern_s = sum(table[n]["ms"] * c for n, c in counts.items()) / 1e3
        print(f"  {label}: kernels {kern_s:.3f} s of {res.wall_time_s:.3f} "
              f"s ({100 * kern_s / res.wall_time_s:.1f} %, kernel ms x "
              f"launches); the rest, {res.wall_time_s - kern_s:.3f} s, is "
              f"the per-step sync, the small products and host work")
    return counts

# ---------------------------------------------------------------------------
# phase 7: the LM serving path (gemma2-9b) and its local_attention kernel
# ---------------------------------------------------------------------------

def instances(build, name: str, log: str) -> tuple:
    """Each kernel of library ``name``: registers and spills from its
    ``nvcc -Xptxas=-v`` log, and tensor-core instructions (``HGMMA`` or
    ``HMMA``) from the SASS of the built library; (info by mangled name,
    count by mangled name).  Prints ptxas's "wgmma serialized" notes."""
    insts, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and "spill stores" in line:
            insts[fn] = {"spill": int(line.split()[4])}
        elif fn in insts and "Used" in line and "registers" in line:
            insts[fn]["regs"] = int(line.split("Used ")[1].split()[0])
        if "C7512" in line or "setmaxnreg" in line:   # wgmma serialized,
            print(f"  {line.strip()}")                   # setmaxnreg ignored
    sass = subprocess.run(
        [build.cuda_tool("cuobjdump"), "-sass",
         str(build.library_path(name))], capture_output=True,
        text=True, check=True).stdout
    mma, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            mma[fn] = 0
        elif fn is not None and ("HGMMA" in line or "HMMA" in line):
            mma[fn] += 1
    return insts, mma


def sweep_instances(build, name: str, log: str, tag: str, dtype: str,
                    want: tuple) -> None:
    """Each tensor-core instance of the block sweeps and ``gram`` of
    library ``name`` (``block_matvec_tc``: kernels ``matvec_tc<N,LD>``,
    ``rmatvec_tc<LD>``, LD = 0 the TMA producer, else the copying one;
    ``block_matvec_tf32``: ``matvec_tf32<N,CP>``, ``rmatvec_tf32<N,CP>``;
    ``gram_tf32``: ``gram_tf32<TRANS,CP>``; CP = 0 the TMA producer, 1 or
    2 the cp.async one; ``tag`` the suffix):
    registers, spills, HGMMA count; fail unless the path's (``want``)
    have HGMMA and spill nothing."""
    import re
    insts, mma = instances(build, name, log)
    path = {}
    for mangled, info in insts.items():
        m = re.search(rf"\d(r?matvec|gram)_{tag}(?:I((?:L[ib]\d+E)+))?",
                      mangled)
        if m is None:
            continue
        args = ",".join(re.findall(r"L[ib](\d+)E", m.group(2) or ""))
        label = m.group(1) + f"_{tag}" + (f"<{args}>" if args else "")
        n_mma = mma.get(mangled, 0)
        print(f"  {name} {label:16s} {dtype}: {info['regs']} registers, "
              f"{info['spill']} bytes spilled, {n_mma} tensor-core "
              f"instructions (HGMMA)")
        if label in want:
            path[label] = (n_mma, info["spill"])
    if sorted(path) != sorted(want) or any(
            n == 0 or sp != 0 for n, sp in path.values()):
        fail(f"{name} path instances (HGMMA, bytes spilled): {path}; want "
             f"tensor-core instructions and no spills")


def attention_instances(build, la, log: str) -> None:
    """Each ``local_attn`` instance's registers, spills and dynamic shared
    memory (``nvcc -Xptxas=-v``) and its tensor-core instructions (SASS of
    the built library); fail unless the bf16 D = 256 instance, the LM
    path's, has tensor-core instructions and spills nothing."""
    import re
    insts, mma = instances(build, "local_attn", log)
    path = None
    for mangled, info in insts.items():
        m = re.search(r"local_attn_(wgmma|ffma)I(f|13__nv_bfloat16)?Li(\d+)E",
                      mangled)
        if m is None:
            continue
        route, D = m.group(1), int(m.group(3))
        dtype = "fp32" if m.group(2) == "f" else "bf16"
        n_mma = mma.get(mangled, 0)
        print(f"  local_attn {route:5s} {dtype} D={D:3d}: {info['regs']} "
              f"registers, {info['spill']} bytes spilled, "
              f"{la.smem_bytes(route, D)} bytes of dynamic shared memory, "
              f"{n_mma} tensor-core instructions (HGMMA/HMMA)")
        if route == "wgmma" and D == 256:
            path = (n_mma, info["spill"])
    if path is None or path[0] == 0 or path[1] != 0:
        fail(f"local_attn bf16 D=256 instance (tensor-core instructions, "
             f"bytes spilled): {path}; want tensor-core instructions and no "
             f"spills")


def attention_bwd_instances(build, la, log: str) -> None:
    """Each ``local_attn_bwd`` instance's registers, spills and tensor-core
    instructions; fail unless every instance of the tensor-core route
    (``bwd_dkdv_wgmma<D>``, ``bwd_dq_wgmma<D>``, D in
    ``WGMMA_HEAD_DIMS``) has tensor-core instructions and spills
    nothing."""
    import re
    insts, mma = instances(build, "local_attn_bwd", log)
    path = {}
    for mangled, info in insts.items():
        m = re.search(r"(bwd_dkdv_wgmma|bwd_dq_wgmma|bwd_dkdv|bwd_dq|"
                      r"bwd_delta)I(f|13__nv_bfloat16)?Li(\d+)E", mangled)
        if m is None:
            continue
        name, D = m.group(1), int(m.group(3))
        dtype = {"f": "fp32", None: "bf16"}.get(m.group(2), "bf16")
        n_mma = mma.get(mangled, 0)
        print(f"  local_attn_bwd {name:14s} {dtype} D={D:3d}: "
              f"{info['regs']} registers, {info['spill']} bytes spilled, "
              f"{n_mma} tensor-core instructions (HGMMA)")
        if name.endswith("_wgmma"):
            path[f"{name}<{D}>"] = (n_mma, info["spill"])
    want = sorted(f"{n}<{D}>" for n in ("bwd_dkdv_wgmma", "bwd_dq_wgmma")
                  for D in la.WGMMA_HEAD_DIMS)
    if sorted(path) != want or any(n == 0 or sp != 0
                                   for n, sp in path.values()):
        fail(f"local_attn_bwd tensor-core instances (HGMMA, bytes spilled): "
             f"{path}; want {want} with tensor-core instructions and no "
             f"spills")


#: csr_sweep.cu's instances on the sparse stream's path at the paper's
#: share (k = 8: a lane a column of a row, eight or four nonzeros ahead;
#: 32-bit keys and indices; float4 rows of Y and Z), each of which must
#: spill nothing; csr_big_buckets<u64,8,0,0> runs too but returns at once
#: unless a bucket holds more than a chunk (its spilled bytes are printed,
#: not held)
CSR_PATH = ("csr_matmat<fp32,1,8,0,0>", "csr_matmat<bf16,1,4,0,0>",
            "csr_records<fp32>", "csr_records<bf16>", "csr_bucket_bounds",
            "csr_bucket_sort<u32>", "csr_runs<8,4,1,0>")


def csr_instances(build, log: str) -> None:
    """Each ``csr_sweep`` kernel's registers and spills (``nvcc
    -Xptxas=-v``): its own (``csr_matmat<V,CW,U,VEC,WIDE>``,
    ``csr_records<V>``, ``csr_bucket_bounds``, ``csr_bucket_sort<K>``,
    ``csr_runs<CW,U,VEC,WIDE>``, ``csr_big_buckets<K,CW,VEC,WIDE>``,
    ``row_gather``) and CUB's radix sort kernels; fail
    unless the path's (``CSR_PATH``) spill nothing."""
    import re
    insts, fn = {}, None                 # no tensor cores: the log alone
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and "spill stores" in line:
            insts[fn] = {"spill": int(line.split()[4])}
        elif fn in insts and "Used" in line and "registers" in line:
            insts[fn]["regs"] = int(line.split("Used ")[1].split()[0])
    path, cub = {}, []
    for mangled, info in sorted(insts.items()):
        m = re.search(r"\d(csr_matmat|csr_records|csr_runs|"
                      r"csr_bucket_bounds|csr_bucket_sort|csr_big_buckets|"
                      r"row_gather)(I.*?)?E", mangled)
        if m is None:
            k = re.search(r"(Device\w*?Kernel)", mangled)
            cub.append(f"{k.group(1) if k else mangled[:40]} "
                       f"{info['regs']}/{info['spill']}")
            continue
        head = mangled[m.end(1):mangled.find("Ev", m.end(1))] \
            if m.group(2) else ""
        args = (["bf16" if "bfloat16" in head else "fp32"]
                if m.group(1) in ("csr_matmat", "csr_records") else
                ["u32" if head.startswith("Ij") else "u64"]
                if m.group(1) in ("csr_bucket_sort", "csr_big_buckets")
                else []) + \
            re.findall(r"L[ib](\d+)E", head)
        label = m.group(1) + (f"<{','.join(args)}>" if args else "")
        print(f"  csr_sweep {label:26s}: {info['regs']} registers, "
              f"{info['spill']} bytes spilled")
        if label in CSR_PATH:
            path[label] = info["spill"]
    print(f"  csr_sweep CUB's kernels (registers/bytes spilled): "
          + ", ".join(cub))
    if sorted(path) != sorted(CSR_PATH) or any(path.values()):
        fail(f"csr_sweep path instances (bytes spilled): {path}; want "
             f"{CSR_PATH} and no spills")


#: csrc/wkv6.cu's backward instances, one a head size, each of which must
#: spill nothing (its states and D sit in registers)
WKV6_BWD_PATH = tuple(f"wkv6_bwd_kernel<{hd}>" for hd in (16, 32, 64, 128))


def wkv6_instances(log: str) -> None:
    """Each ``wkv6`` kernel's registers and spills (``nvcc -Xptxas=-v``):
    the forward's ``wkv6_kernel<HD, STATES>`` and the backward's
    ``wkv6_bwd_kernel<HD>``; fail unless every backward instance
    (``WKV6_BWD_PATH``) is built and spills nothing."""
    import re
    insts, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and "spill stores" in line:
            insts[fn] = {"spill": int(line.split()[4])}
        elif fn in insts and "Used" in line and "registers" in line:
            insts[fn]["regs"] = int(line.split("Used ")[1].split()[0])
    bwd = {}
    for mangled, info in sorted(insts.items()):
        m = re.search(r"\d(wkv6_bwd_kernel|wkv6_kernel)ILi(\d+)E(?:Lb([01])E)?",
                      mangled)
        if m is None:
            continue
        label = f"{m.group(1)}<{m.group(2)}" + (
            f", {'true' if m.group(3) == '1' else 'false'}"
            if m.group(3) is not None else "") + ">"
        print(f"  wkv6 {label:28s}: {info['regs']} registers, "
              f"{info['spill']} bytes spilled")
        if m.group(1) == "wkv6_bwd_kernel":
            bwd[label] = info["spill"]
    if sorted(bwd) != sorted(WKV6_BWD_PATH) or any(bwd.values()):
        fail(f"wkv6 backward instances (bytes spilled): {bwd}; want "
             f"{WKV6_BWD_PATH} and no spills")


# the planted faults of phase 2b: (library, its -D flag)
PLANTED = (("block_matvec_tc", "REPRO_TC_SUMS_ONLY"),
           ("block_matvec_tc", "REPRO_NO_ZFILL"),
           ("block_matvec_tf32", "REPRO_TF32_ONLY"),
           ("block_matvec_tf32", "REPRO_TC_SUMS_ONLY"),
           ("block_matvec_tf32", "REPRO_NO_ZFILL"),
           ("gram_tf32", "REPRO_TF32_ONLY"),
           ("gram_tf32", "REPRO_TC_SUMS_ONLY"),
           ("gram_bf16", "REPRO_TC_SUMS_ONLY"))
# the backward's precision, as planted faults read in phase 12 (printed,
# not held to a limit): P and dS in two bf16 terms, and the sums left in
# the tensor cores
BWD_PLANTED = (("local_attn_bwd", "REPRO_TWO_TERMS"),
               ("local_attn_bwd", "REPRO_TC_SUMS_ONLY"))
# builds for timing alone, beside the planted faults: the staging with no
# products of bf16 gram (phase 5) and of the bf16 sweeps (phase 3, on
# wgmma_ld): where the kernels' time goes
TIMING = (("gram_bf16", "REPRO_STAGING_ONLY"),
          ("block_matvec_tc", "REPRO_STAGING_ONLY"))


def build_planted(build, name: str, flag: str) -> tuple:
    """Start ``nvcc`` on ``csrc/<name>.cu`` with ``-D<flag>`` (a planted
    fault of phase 2b) beside the real build; returns (the process, the
    library it writes)."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / f"{name}-{flag.lower()}.so"
    proc = subprocess.Popen(
        [build.cuda_tool("nvcc"), *build.NVCC_FLAGS, f"-D{flag}",
         "-o", str(out), str(build.CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


FAULT_LABELS = {"REPRO_TC_SUMS_ONLY": "the sums left in the tensor cores",
                "REPRO_TF32_ONLY": "plain TF32 (the hi hi term alone)",
                "REPRO_NO_ZFILL": "the columns past n copied, not zero-filled"}


def outside(e: float, tol: float) -> bool:
    """A reading outside the limit: above it, or not a number at all."""
    return not e <= tol


def planted_faults(torch, bm, ref, planted, sd, g, dev, inputs, width=N,
                   ld=None, seen=None) -> dict:
    """The sweeps of dtype ``sd`` on the route ``A`` takes (bf16:
    ``wgmma``, or ``wgmma_ld`` where no tensor map describes ``A``; fp32:
    ``tf32x3``, or ``tf32x3_cpasync``) and the same sweeps from each
    planted-fault library of ``planted`` ({(library, flag): path}),
    against the plain version on 65536 x ``width`` inputs, rows ``ld``
    apart (default ``width``) in an allocation of one row more, every
    element outside the view NaN: ``"abs"``, an |N(0, 1)| ``A`` with skinny operands
    uniform in [0, 1) (every partial sum grows, as a truncating
    accumulator likes least), and ``"signed"``, N(0, 1) ``A`` and skinny
    operands (the sums cancel, so a rounding error of each product is
    not averaged away against a growing sum).  Fail unless the real
    sweeps are within the limit on every input and every planted fault
    reads outside it on at least one, in each sweep of ``seen[flag]``
    (default both).  Returns the errors by input."""
    m = 65536
    ld = width if ld is None else ld
    dt = getattr(torch, sd)
    tol = TOL[sd]
    errs = {}
    for kind in inputs:
        flat = torch.full(((m + 1) * ld,), float("nan"), dtype=dt, device=dev)
        A = flat[:m * ld].view(m, ld)[:, :width]
        for r in range(0, m, SLAB):
            x = torch.randn((SLAB, width), generator=g, device=dev)
            A[r:r + SLAB] = x.abs_() if kind == "abs" else x
            del x
        draw = torch.rand if kind == "abs" else torch.randn
        Q = draw((width, K), generator=g, device=dev).to(dt)
        Y = draw((m, K), generator=g, device=dev).to(dt)
        which = bm.route(A, K)
        want = {"block_matvec": plain_matvec(torch, ref, A, Q, sd),
                "block_rmatvec": plain_rmatvec(torch, ref, A, Y, sd)}

        def run():
            return {"block_matvec": bm.block_matvec_cuda(A, Q, which),
                    "block_rmatvec": bm.block_rmatvec_cuda(A, Y, which)}
        runs = {"real": run()}
        for (lib, flag), path in planted.items():
            runs[flag] = planted_run(bm, lib, path, run)
        torch.cuda.synchronize()
        for name in want:
            e = errs[(kind, name)] = {
                key: rel_err(torch, out[name], want[name])
                for key, out in runs.items()}
            print(f"  {name:16s} {sd} ({which}) {m}x{width} (rows {ld} "
                  f"apart) k={K}, {kind} "
                  f"input: rel err {e['real']:.2e}" + "".join(
                      f"; with {FAULT_LABELS[flag]} {e[flag]:.2e}"
                      for flag in runs if flag != "real")
                  + f" (limit {tol:.0e})")
            if outside(e["real"], tol):
                fail(f"{name} {sd} on the {kind} input: rel err "
                     f"{e['real']} > {tol}")
        del A, flat, Q, Y, want, runs
        torch.cuda.empty_cache()
    for _, flag in planted:
        for name in (seen or {}).get(flag, ("block_matvec",
                                            "block_rmatvec")):
            if not any(outside(errs[(kind, name)][flag], tol)
                       for kind in inputs):
                fail(f"{name} {sd} with {FAULT_LABELS[flag]} reads within "
                     f"the limit {tol} on every input: the check cannot "
                     f"see it")
    return errs


def planted_run(kernels, lib: str, path, fn):
    """``fn()`` with library ``lib`` taken from the planted-fault build at
    ``path`` in place of the real one (``kernels``: the binding module,
    whose ``build.library`` loads the libraries)."""
    import ctypes
    fault = ctypes.CDLL(str(path))
    library = kernels.build.library
    kernels.build.library = lambda name: (fault if name == lib
                                          else library(name))
    try:
        return fn()
    finally:
        kernels.build.library = library


def gram_planted_faults(torch, gm, ref, planted, g, dev,
                        sd="float32") -> dict:
    """``gram`` of dtype ``sd`` on the route ``A`` takes (contiguous: fp32
    ``tf32x3``, bf16 ``wgmma``) and from each planted-fault library of
    ``planted`` ({(library, flag): path}) against the plain version on
    ``GRAM_FAULT`` inputs of the gram path's aspect: ``"abs"``, |N(0, 1)| (every sum grows, as a truncating
    accumulator likes least), and ``"signed"``, N(0, 1) (the off-diagonal
    sums cancel, so a rounding error of each product is not averaged
    away).  Both of phase 4's readings: the whole product against
    ``gram_tol``, its off-diagonal entries against ``TOL_GRAM_OFFDIAG``.
    Fail unless the real kernel is within both on every input and every
    planted fault reads outside the off-diagonal limit on at least one.
    Returns the readings by input."""
    m, n = GRAM_FAULT
    tol = gram_tol(m)
    readings = {}
    for kind in ("abs", "signed"):
        A = torch.randn((m, n), generator=g, device=dev)
        if kind == "abs":
            A.abs_()
        A = A.to(getattr(torch, sd))
        which = gm.route(A)
        want = ref.gram_ref(A)
        runs = {"real": gm.gram_cuda(A, which)}
        for (lib, flag), path in planted.items():
            runs[flag] = planted_run(gm, lib, path,
                                     lambda: gm.gram_cuda(A, which))
        torch.cuda.synchronize()
        r = readings[kind] = {
            key: (rel_err(torch, B, want), gram_offdiag_err(torch, B, want))
            for key, B in runs.items()}
        print(f"  gram {sd} ({which}) {m}x{n}, {kind} input: rel err "
              f"{r['real'][0]:.2e} (limit {tol:.1e}), off the diagonal "
              f"{r['real'][1]:.2e} (limit {TOL_GRAM_OFFDIAG:.0e})" + "".join(
                  f"; with {FAULT_LABELS[flag]} {r[flag][0]:.2e}, off the "
                  f"diagonal {r[flag][1]:.2e}"
                  for flag in r if flag != "real"))
        if outside(r["real"][0], tol) or outside(r["real"][1],
                                                 TOL_GRAM_OFFDIAG):
            fail(f"gram {sd} on the {kind} input: readings {r['real']}")
        del A, want, runs
    for _, flag in planted:
        if not any(outside(readings[kind][flag][1], TOL_GRAM_OFFDIAG)
                   for kind in readings):
            fail(f"gram {sd} with {FAULT_LABELS[flag]} reads within the "
                 f"off-diagonal limit {TOL_GRAM_OFFDIAG} on every input: the "
                 f"check cannot see it")
    return readings


def attn_share(got, want, dtype: str) -> float:
    """The worst |kernel - plain| of ``local_attention`` as a share of its
    limit, element by element: fp32 1e-4 (the JAX package's,
    ``tests/test_kernels.py:208``); bf16 the kernel's one rounding of
    its fp32 output to bf16, at most half a bf16 step, 2^-8 |o|, of
    that element, plus ``ATOL_ATTN_BF16`` for fp32 sums in another
    order.  Each element is held to its own size: most rows average
    thousands of keys and are small, so a limit from the largest output
    would pass a wrong key tile there."""
    err = (got.float() - want).abs()
    if dtype == "float32":
        return float(err.max()) / TOL_ATTN_FP32
    return float((err / (2.0 ** -8 * want.abs() + ATOL_ATTN_BF16)).max())


def attn_inputs(torch, g, dev, B, H, Hkv, S, D, dtype):
    """q (B, H, S, D), k, v (B, Hkv, S, D): views of (B, S, H, D) memory,
    as the model passes its projections."""
    return [torch.randn((B, S, h, D), generator=g, device=dev)
            .to(dtype).transpose(1, 2) for h in (H, Hkv, Hkv)]


def plain_attention(ref, q, k, v, window, softcap, each=None):
    """The plain version two query heads (one K/V head group slice) at a
    time, so its (S, S) scores stay a few GB; ``each(h0, out)`` sees every
    chunk."""
    H, Hkv = q.shape[1], k.shape[1]
    group = H // Hkv
    step = max(2, group)
    for h0 in range(0, H, step):
        out = ref.local_attention_ref(
            q[:, h0:h0 + step], k[:, h0 // group:(h0 + step - 1) // group + 1],
            v[:, h0 // group:(h0 + step - 1) // group + 1], window=window,
            softcap=softcap)
        if each is not None:
            each(h0, out)
        del out


def attn_readings(torch, ref, outs, q, k, v, window, softcap) -> tuple:
    """Each output of ``outs`` against the plain version, chunked: (max
    |out - plain| of the first, and each one's worst share of the
    bf16 per-element limit)."""
    mae, shares = 0.0, [0.0] * len(outs)

    def each(h0, want):
        nonlocal mae
        for i, out in enumerate(outs):
            got = out[:, h0:h0 + want.shape[1]]
            if i == 0:
                mae = max(mae, float((got.float() - want).abs().max()))
            shares[i] = max(shares[i], attn_share(got, want, "bfloat16"))
    plain_attention(ref, q, k, v, window, softcap, each)
    return mae, shares


def attn_bound(B, H, Hkv, S, D, window) -> tuple:
    """Least time on an H100 SXM: 4 D flop per live (query, key) pair over
    the bf16 tensor-core peak, against q, k, v read once and o written
    once (bf16) over the memory rate."""
    w = min(window, S)
    pairs = B * H * (w * (w + 1) // 2 + (S - w) * w)
    nbytes = 2 * B * S * D * (2 * H + 2 * Hkv)
    return pick(nbytes / PEAK_BYTES * 1e3,
                pairs * 4 * D / PEAK_OPS["bfloat16"] * 1e3)


def attention_ragged(torch, ops, ref, la, g, dev) -> float:
    """``local_attention`` against its plain version at ragged shapes,
    fp32 and bf16, every head dim of the template; the worst error as a
    share of its limit."""
    worst = 0.0
    for D in la.HEAD_DIMS:
        for (B, H, Hkv, S, window, softcap) in [(2, 4, 2, 333, 64, 50.0),
                                                (1, 6, 3, 130, 200, None),
                                                (3, 2, 1, 65, 1, 30.0),
                                                (1, 8, 1, 129, 1000, 50.0)]:
            for sd in ("float32", "bfloat16"):
                q, k, v = attn_inputs(torch, g, dev, B, H, Hkv, S, D,
                                      getattr(torch, sd))
                got = ops.local_attention(q, k, v, window=window,
                                          softcap=softcap)
                want = ref.local_attention_ref(q, k, v, window=window,
                                               softcap=softcap)
                torch.cuda.synchronize()
                e = float((got.float() - want).abs().max())
                share = attn_share(got, want, sd)
                label = (f"local_attention {sd} ({la.route(q.dtype, D)}) B={B} "
                         f"H={H} Hkv={Hkv} S={S} D={D} window={window} "
                         f"softcap={softcap}")
                print(f"  {label}: max abs err {e:.2e}, {share:.2f} of the "
                      f"per-element limit")
                if not (got.dtype == q.dtype and got.shape == q.shape
                        and bool(torch.isfinite(got).all()) and share <= 1):
                    fail(f"{label}: {share} of the per-element limit")
                worst = max(worst, share)
    return worst


def attention_path_table(torch, ops, ref, la, g, dev, cfg, S) -> dict:
    """The kernel at the path's shapes, one row per layer kind: checked
    against the plain version, then timed beside its bound, the plain
    version and ``scaled_dot_product_attention`` (band mask; both
    without the soft-cap, since no single PyTorch call soft-caps), and on
    the global layer also ``is_causal=True`` with no mask tensor
    (``library_causal_ms``: the flash backend; no call takes a window)."""
    import torch.nn.functional as F
    B, H, Hkv, D = LM_BATCH, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    q, k, v = attn_inputs(torch, g, dev, B, H, Hkv, S, D, torch.bfloat16)
    rows = {}
    for kind, window in (("local", cfg.window), ("attn", S)):
        cap = cfg.attn_softcap
        got = ops.local_attention(q, k, v, window=window, softcap=cap)
        # a planted fault the limit must reject: one key tile short
        short_w = max(1, window - la.BK)
        short = ops.local_attention(q, k, v, window=short_w, softcap=cap)
        torch.cuda.synchronize()
        mae, (share, fault) = attn_readings(torch, ref, [got, short], q, k, v,
                                            window, cap)
        label = (f"local_attention bf16 {kind} B={B} H={H} Hkv={Hkv} S={S} "
                 f"D={D} window={window} softcap={cap}")
        if not (bool(torch.isfinite(got).all()) and share <= 1):
            fail(f"{label}: {share} of the per-element limit")
        if fault <= 1:
            fail(f"{label}: window {short_w} reads {fault} of the per-element "
                 f"limit; the check cannot see a missing key tile")
        del got, short
        pos = torch.arange(S, device=dev)
        band = (pos[None, :] <= pos[:, None]) & (pos[None, :]
                                                 > pos[:, None] - window)
        kr = k.repeat_interleave(H // Hkv, dim=1).contiguous()
        vr = v.repeat_interleave(H // Hkv, dim=1).contiguous()
        qc = q.contiguous()
        row = {"max_abs_err": mae, "share_of_limit": share,
               "tile_short_share": fault,
               "ms": time_ms(torch, lambda: ops.local_attention(
                   q, k, v, window=window, softcap=cap), 10),
               "plain_ms": time_ms(torch, lambda: plain_attention(
                   ref, q, k, v, window, cap), 1),
               "nocap_ms": time_ms(torch, lambda: ops.local_attention(
                   q, k, v, window=window, softcap=None), 10),
               "library_ms": time_ms(
                   torch, lambda: F.scaled_dot_product_attention(
                       qc, kr, vr, attn_mask=band), 3)}
        if kind == "attn":
            row["library_causal_ms"] = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qc, kr, vr, is_causal=True), 10)
        row["bound_ms"], row["bound_by"] = attn_bound(B, H, Hkv, S, D, window)
        rows[kind] = row
        del kr, vr, qc, band
        print(f"  {label}: max abs err {mae:.2e}, {share:.2f} of the "
              f"per-element limit (window {short_w}, a key tile short: "
              f"{fault:.1f} of it), kernel "
              f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, bound "
              f"{row['bound_ms']:.3f} ms ({row['bound_by']}); without the "
              f"soft-cap: kernel {row['nocap_ms']:.3f} ms, "
              f"scaled_dot_product_attention {row['library_ms']:.3f} ms "
              f"(band mask)" + (
                  f", {row['library_causal_ms']:.3f} ms (is_causal=True)"
                  if "library_causal_ms" in row else ""))
    torch.cuda.empty_cache()
    return rows


def profile_window(torch, fn, calls=None) -> tuple:
    """``fn()`` under ``torch.profiler``: (its result, wall seconds under
    the profiler, device-busy seconds, device activities, busy seconds
    by activity name); ``calls``, a dict, receives the activities by
    name.  Busy time is the sum of the device activities' spans (one
    stream, so they do not overlap)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    n = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e6
            if calls is not None:
                calls[e.name] = calls.get(e.name, 0) + 1
    return out, wall, sum(by_name.values()), n, by_name


def planted_decode_faults(torch, T, model, cache, nxt, S) -> dict:
    """The logits of the decode at position ``S`` with a fault planted in
    a copy of ``cache``: the readings that set ``TOL_CONSISTENCY``."""
    out = {}
    for name in ("position off by one", "the last prompt position's slot "
                 "skipped", "local window one key short", "cache empty"):
        bad = [{n: t.clone() for n, t in c.items()} for c in cache]
        pos = S
        for c, kind in zip(bad, model.cfg.blocks):
            Lc = c["pos"].shape[0]
            if name == "position off by one":
                pos = S + 1
            elif name.startswith("the last"):
                c["pos"][(S - 1) % Lc] = -1
            elif name.startswith("local") and kind == "local":
                c["pos"][(S - model.cfg.window + 1) % Lc] = -1
            elif name == "cache empty":
                c["pos"].fill_(-1)
        out[name] = T.decode_step(model, bad, nxt, pos)[0]
        del bad
    return out


def smoke_serve(torch, T, serve, model, dev, tokens, plant=False) -> tuple:
    """The fp32 smoke model on ``dev``: a prefill of the prompt
    ``tokens[:, :CACHE_PROMPT]``, then ``CACHE_STEPS`` decode steps fed
    the next columns of ``tokens``; with ``plant``, the slot of the last
    prompt position is marked empty in every layer's cache after the
    prefill (a skipped cache slot).  Returns (each step's logits on the
    CPU, the final cache on the CPU)."""
    logits, cache, _ = serve.serve_prefill(
        model, tokens[:, :CACHE_PROMPT].to(dev), CACHE_PROMPT + CACHE_STEPS)
    if plant:
        for c in cache:
            c["pos"][(CACHE_PROMPT - 1) % c["pos"].shape[0]] = -1
    out = [logits.cpu()]
    for i in range(CACHE_STEPS):
        pos = CACHE_PROMPT + i
        logits, cache = T.decode_step(model, cache,
                                      tokens[:, pos:pos + 1].to(dev), pos)
        out.append(logits.cpu())
    return out, [{n: t.cpu() for n, t in c.items()} for c in cache]


def cache_reading(torch, got, want) -> tuple:
    """The worst relative Frobenius error over every step's logits and
    every float cache tensor of ``got`` against ``want``, and whether
    their integer cache tensors (the slots' positions) are equal."""
    (lg, cg), (lw, cw) = got, want
    errs = [rel_err(torch, a, b) for a, b in zip(lg, lw)]
    same = True
    for a, b in zip(cg, cw):
        for name in b:
            if b[name].is_floating_point():
                errs.append(rel_err(torch, a[name], b[name]))
            else:
                same = same and torch.equal(a[name], b[name])
    return max(errs), same


def smoke_cache_check(torch, T, serve, dev) -> dict:
    """The fp32 smoke config of gemma2-9b served on the card and on the
    CPU with the same seed-0 weights (drawn on the CPU, copied to the
    card); fail unless every step's logits and every cache tensor agree
    within ``TOL_CACHE`` and the slots hold the same positions, and
    unless the card's serve with a skipped cache slot reads above
    ``TOL_CACHE``.  Returns the readings."""
    import copy
    cpu = torch.device("cpu")
    model = serve.build(LM_ARCH, smoke=True, device=cpu, seed=LM_SEED)
    cfg = model.cfg
    prompt = serve.make_prompt(cfg, LM_BATCH, CACHE_PROMPT, seed=LM_SEED,
                               device=cpu)
    # the decode feeds the CPU's greedy tokens on both devices
    logits, cache, _ = serve.serve_prefill(model, prompt,
                                           CACHE_PROMPT + CACHE_STEPS)
    fed, _, _ = serve.serve_decode(model, cache, logits, CACHE_PROMPT,
                                   CACHE_STEPS)
    tokens = torch.cat([prompt, fed], dim=1)
    want = smoke_serve(torch, T, serve, model, cpu, tokens)
    card = copy.deepcopy(model).to(dev)
    sound, same = cache_reading(
        torch, smoke_serve(torch, T, serve, card, dev, tokens), want)
    fault, _ = cache_reading(
        torch, smoke_serve(torch, T, serve, card, dev, tokens, plant=True),
        want)
    print(f"{cfg.name} fp32 (window {cfg.window}), card vs CPU, prefill "
          f"{CACHE_PROMPT} tokens + {CACHE_STEPS} decode steps: worst rel "
          f"err over the logits and cache tensors {sound:.2e} (limit "
          f"{TOL_CACHE:.0e}), slot positions equal: {same}; with the last "
          f"prompt position's slot skipped {fault:.2e}")
    if not (same and sound <= TOL_CACHE):
        fail(f"smoke serve card vs CPU: rel err {sound} (limit {TOL_CACHE}), "
             f"positions equal {same}")
    if not fault > TOL_CACHE:
        fail(f"a skipped cache slot reads {fault}, within the limit "
             f"{TOL_CACHE}: the check cannot see it")
    return {"sound": sound, "skipped_slot": fault}


def lm_serving(torch, ops, ref, la, g, dev) -> tuple:
    """Phase 7; returns (the kernel's JSON row, its launches per prefill)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    smoke_cache_check(torch, T, serve, dev)
    worst = attention_ragged(torch, ops, ref, la, g, dev)
    print(f"local_attention at ragged shapes: all within limits (worst "
          f"{worst:.2f} of limit)")
    cfg = get_config(LM_ARCH)
    S, steps = LM_PROMPT, LM_TOKENS
    rows = attention_path_table(torch, ops, ref, la, g, dev, cfg, S)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = serve.build(LM_ARCH, device=dev, seed=LM_SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"{cfg.name}: {cfg.num_layers} layers ({cfg.blocks.count('local')} "
          f"local, window {cfg.window}), {n_params / 1e9:.3f} B parameters "
          f"({w_bytes / 1e9:.2f} GB {cfg.dtype}) drawn on the card from seed "
          f"{LM_SEED} in {time.perf_counter() - t0:.1f} s")
    prompt = serve.make_prompt(cfg, LM_BATCH, S, seed=LM_SEED, device=dev)

    ops.reset_launches()
    logits, cache, t_pre = serve.serve_prefill(model, prompt, S + steps)
    pre_counts = {n: c for n, c in ops.launches.items() if c}
    ops.reset_launches()
    tokens, last, t_dec = serve.serve_decode(model, cache, logits, S, steps)
    dec_counts = {n: c for n, c in ops.launches.items() if c}
    peak = torch.cuda.max_memory_allocated()
    cache_bytes = sum(c[n].numel() * c[n].element_size() for c in cache
                      for n in ("k", "v"))
    print(f"serve {cfg.name} batch {LM_BATCH}: prefill {S} tokens "
          f"{t_pre:.3f} s ({LM_BATCH * S / t_pre:.0f} tokens/s), "
          f"local_attention launches {pre_counts}; {steps} greedy decode "
          f"steps {t_dec:.3f} s ({steps * LM_BATCH / t_dec:.1f} tokens/s, "
          f"{1e3 * t_dec / steps:.2f} ms a step; weight-read bound "
          f"{w_bytes / PEAK_BYTES * 1e3:.2f} ms), launches {dec_counts}; KV "
          f"caches {cache_bytes / 1e9:.2f} GB; peak device memory "
          f"{peak / 2**30:.1f} GiB")
    print(f"  seq0: {tokens[0, :16].tolist()}")
    if pre_counts != {"local_attention": cfg.num_layers}:
        fail(f"prefill launches {pre_counts}, want one local_attention a "
             f"layer ({cfg.num_layers})")
    if dec_counts:
        fail(f"decode launched kernels {dec_counts}; it runs the plain "
             f"cache path")
    if not (tokens.shape == (LM_BATCH, steps)
            and int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size
            and bool(torch.isfinite(logits).all())
            and bool(torch.isfinite(last).all())
            and logits.shape == (LM_BATCH, cfg.vocab_size)):
        fail("serve: non-finite logits or tokens out of range")
    del cache, last

    # determinism, then decode at position S against a prefill over S + 1
    again, cache, t_again = serve.serve_prefill(model, prompt, S + 3)
    same = torch.equal(again, logits)
    print(f"rerun prefill: {t_again:.3f} s, logits bitwise equal: {same}")
    if not same:
        fail("two prefills of the same prompt differ")
    nxt = torch.argmax(again, dim=-1)[:, None]
    faulty = planted_decode_faults(torch, T, model, cache, nxt, S)
    dec, _ = T.decode_step(model, cache, nxt, S)
    # where the device time goes: two more decode steps, then the prefill
    # over S + 1 tokens that the decode is checked against
    _, w2, busy2, n2, _ = profile_window(torch, lambda: [
        T.decode_step(model, cache, nxt, S + i) for i in (1, 2)])
    del cache
    full, w1, busy1, n1, names = profile_window(
        torch, lambda: T.prefill(model, torch.cat([prompt, nxt], dim=1),
                                 None)[0])
    if n1 and n2:
        attn = sum(t for name, t in names.items() if "local_attn" in name)
        step = t_dec / steps
        print(f"profile of the prefill over {S + 1} tokens: {w1:.3f} s under "
              f"the profiler, device busy {busy1:.3f} s ({100 * busy1 / w1:.1f}"
              f" %), {n1} device activities; local_attention kernels "
              f"{attn:.3f} s ({100 * attn / busy1:.1f} % of busy); the rest "
              f"by time: " + ", ".join(
                  f"{name[:40]} {t:.3f} s" for name, t in sorted(
                      ((n, t) for n, t in names.items()
                       if "local_attn" not in n), key=lambda x: -x[1])[:4]))
        print(f"profile of two decode steps: device busy {1e3 * busy2 / 2:.2f}"
              f" ms a step against {1e3 * step:.2f} ms a step unprofiled "
              f"(device idle share {100 * (1 - busy2 / 2 / step):.1f} %), "
              f"{n2 / 2:.0f} device activities a step")
    else:
        print("profiles: not measured (the profiler saw no device activity)")
    e = rel_err(torch, dec, full)
    print(f"decode at position {S} vs prefill over {S + 1} tokens: rel err "
          f"{e:.2e} (limit {TOL_CONSISTENCY:.0e}), max abs "
          f"{float((dec - full).abs().max()):.3e} of max |logit| "
          f"{float(full.abs().max()):.2f}")
    readings = {name: rel_err(torch, f, full) for name, f in faulty.items()}
    for name, r in readings.items():
        print(f"  planted decode fault, {name}: rel err {r:.2e}")
    if not (bool(torch.isfinite(dec).all()) and e <= TOL_CONSISTENCY):
        fail(f"decode vs prefill logits: rel err {e} > {TOL_CONSISTENCY}")
    unseen = [n for n in FAULTS_SEEN if readings[n] <= TOL_CONSISTENCY]
    if unseen:
        fail(f"planted decode faults {unseen} read within the limit "
             f"{TOL_CONSISTENCY}: the check cannot see them")
    del model, full, dec, faulty
    torch.cuda.empty_cache()

    n_local = cfg.blocks.count("local")
    n_global = cfg.num_layers - n_local
    mean = lambda key: (n_local * rows["local"][key]
                        + n_global * rows["attn"][key]) / cfg.num_layers
    row = {key: mean(key) for key in ("ms", "plain_ms", "bound_ms",
                                      "library_ms", "nocap_ms")}
    row["max_abs_err"] = max(r["max_abs_err"] for r in rows.values())
    row["bound_by"] = rows["local"]["bound_by"]
    row["library_causal_ms"] = rows["attn"]["library_causal_ms"]
    print(json.dumps({"local_attention_by_layer_kind": rows}))
    return row, pre_counts["local_attention"]


# ---------------------------------------------------------------------------
# phase 8: the out-of-core tiers (host-blocked and disk) on the ported
# kernels
# ---------------------------------------------------------------------------

OOC_ROWS = 655360                      # x N fp32: 80 GiB, more than the card
OOC_BLOCKS = 4                         # SVDConfig's default n_blocks
H2D_PROBE = 1 << 29                    # fp32 elements: the 2 GiB rate probe
PCIE_PEAK = 64e9                       # B/s host -> device: PCIe Gen5 x16, the
                                       # data sheet's 128 GB/s both ways
K_OOC_GRAMFREE, K_DISK = 2, 8
DISK_ROWS = 131072                     # x N_GRAM: 8.6's A, cut in depth from
                                       # 262144 rows (the script's 850 s aim)
DEMOTE = (65536, 8192)
DEMOTE_ITERS = 10                      # force_iters of the demotion runs


def host_limits() -> dict:
    """What the host allows the out-of-core tiers: memory (``/proc/
    meminfo``), the locked-memory limit (``ulimit -l``; page-locking by
    the CUDA driver is not charged to it), the temp directory's disk."""
    import resource
    import shutil
    import tempfile
    mem = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable", "Cached"):
                mem[key] = int(val.split()[0]) * 1024
    lock = resource.getrlimit(resource.RLIMIT_MEMLOCK)[0]
    tmp = tempfile.gettempdir()
    du = shutil.disk_usage(tmp)
    return {"mem_total": mem["MemTotal"], "mem_available": mem["MemAvailable"],
            "page_cache": mem["Cached"],
            "memlock": None if lock == resource.RLIM_INFINITY else lock,
            "tmp": tmp, "tmp_free": du.free, "cpus": os.cpu_count()}


H2D_REPS = 5                           # timed copies of each probe


def copy_rates(torch, fn, nbytes, timer="events") -> list:
    """Bytes/s of each of ``H2D_REPS`` runs of the copy ``fn``, after one
    warm-up: timed by CUDA events, or (``timer="host"``, for a pageable
    copy, which the host stages itself) by the host clock around each
    run and a sync."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(H2D_REPS):
        if timer == "host":
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(nbytes / (time.perf_counter() - t0))
            continue
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        out.append(nbytes / t0.elapsed_time(t1) * 1e3)
    return out


def h2d_rates(torch, staging, dev) -> dict:
    """Bytes/s of 2 GiB host -> device copies, each timed alone: from
    pinned memory (the best of them is the out-of-core tiers' bound, as
    3.35 TB/s is the dense tier's: one copy's rate varies by ~10 % with
    the host memory it reads), from pageable memory, and through
    ``staging.H2DRing`` (rows of 32 KiB, one run of bytes; and rows of
    8191 fp32 into device rows padded to 8192, the pitched copy)."""
    n = H2D_PROBE
    src, key = staging.pinned_empty((n,), torch.float32)
    src.fill_(1.0)
    dst = torch.empty((n,), device=dev)
    runs = {"pinned": copy_rates(
        torch, lambda: dst.copy_(src, non_blocking=True), n * 4)}
    page = torch.ones((n,), dtype=torch.float32)
    runs["pageable"] = copy_rates(torch, lambda: dst.copy_(page), n * 4,
                                  timer="host")
    del page, dst
    rows = n // 8192
    for label, width in (("ring", 8192), ("pitched", 8191)):
        ring = staging.H2DRing(rows, width, torch.float32, dev)
        view = src[:rows * width].view(rows, width)
        got = ring.put(view)
        torch.cuda.synchronize()
        if not torch.equal(got, torch.ones_like(got)):
            fail(f"H2DRing ({label}): the copied block differs")
        runs[label] = copy_rates(torch, lambda: ring.put(view),
                                 rows * width * 4)
        ring.close()
        del ring, got
    torch.cuda.empty_cache()
    staging.unregister(key)
    rates = {label: max(r) for label, r in runs.items()}
    rates.update({f"{label}_median": sorted(r)[len(r) // 2]
                  for label, r in runs.items()})
    return rates


def _union(iv: list) -> list:
    out: list = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _length(iv: list) -> float:
    return sum(b - a for a, b in iv)


def _overlap(x: list, y: list) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(x) and j < len(y):
        lo, hi = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        total += max(0.0, hi - lo)
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


def copy_profile(torch, fn) -> tuple:
    """``fn()`` under ``torch.profiler``: its result and where the device
    time went with the copy engine in the picture: wall seconds, device
    busy (any kernel or copy running), the copy engine busy (host ->
    device copies), kernel time, and the share of kernel time that ran
    while a copy did (hidden under it)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern, copy = [], []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            iv = (e.time_range.start / 1e6, e.time_range.end / 1e6)
            (copy if "memcpy" in e.name.lower() else kern).append(iv)
    ku, cu = _union(kern), _union(copy)
    k_s = _length(ku)
    return out, {"wall_s": wall, "busy_s": _length(_union(kern + copy)),
                 "copy_s": _length(cu), "kernel_s": k_s, "copies": len(copy),
                 "kernels": len(kern),
                 "hidden": _overlap(ku, cu) / k_s if k_s else None}


def hb_solve(torch, repro_torch, ops, X, label, s, dense, rate, *,
             rtol=1e-4, chains="tf32x3", profile=False, **kw) -> dict:
    """One block solve on the host-blocked tier, held to the prescribed
    spectrum ``s`` and the dense solve's sigma ``dense`` (``rtol``), to
    the pass accounting (passes = iters + 1; a ``CountingHostMatrix``'s
    fetches = passes x n_blocks), to the launches (n_blocks x passes by
    route: the chains on ``chains``, the fp32 extraction on ``tf32x3``)
    and to ``bytes_moved``; seconds per pass against ``bytes_per_pass`` /
    the pinned rate ``rate``.  ``profile``: a second solve under the
    profiler.  Returns its numbers."""
    nb = getattr(X, "n_blocks", OOC_BLOCKS)
    ops.reset_launches()
    res = repro_torch.svd(X, K, **kw)
    counts = {n: c for n, c in ops.launches.items() if c}
    routes = {n: c for n, c in ops.route_launches.items() if c}
    it = int(res.iters[0])
    p, bpp = res.passes_over_A, res.bytes_per_pass
    err = float((res.S.double().cpu() / s[:K].double().cpu() - 1)
                .abs().max())
    err_dense = float((res.S.double() / dense.double() - 1).abs().max())
    per_pass = res.wall_time_s / p
    bound = bpp / rate
    fetches = getattr(X, "fetches", None)
    print(f"{label}: backend {res.backend}, iters {it}, passes_over_A {p}, "
          f"fetches {fetches}, bytes_per_pass {bpp}, bytes_moved "
          f"{res.bytes_moved}, converged {res.converged}, wall_time_s "
          f"{res.wall_time_s:.3f}, {per_pass:.4f} s a pass against "
          f"{bound:.4f} s at the pinned rate ({100 * bound / per_pass:.1f} "
          f"%; {bpp / per_pass / 1e9:.2f} GB/s a pass), launches {counts} (by "
          f"route {routes}), max sigma rel err {err:.2e} (against the dense "
          f"solve {err_dense:.2e}; limit {rtol:.0e})")
    want = {"block_gram_chain": nb * it, "block_matvec": nb * (it + 1),
            "block_rmatvec": nb * it}
    want_routes = {f"block_matvec/{chains}": nb * it,
                   f"block_rmatvec/{chains}": nb * it}
    want_routes["block_matvec/tf32x3"] = \
        want_routes.get("block_matvec/tf32x3", 0) + nb
    if res.backend != "hostblocked" or p != it + 1:
        fail(f"{label}: backend {res.backend}, passes {p} for {it} iters")
    if fetches is not None and fetches != p * nb:
        fail(f"{label}: {fetches} fetches for {p} passes of {nb} blocks")
    if counts != want or routes != want_routes:
        fail(f"{label}: launches {counts} by route {routes}; n_blocks x "
             f"passes implies {want} by route {want_routes}")
    if res.bytes_moved != {"host": p * bpp, "device": p * bpp}:
        fail(f"{label}: bytes_moved {res.bytes_moved}")
    if not (res.converged and err <= rtol and err_dense <= rtol
            and bool(torch.isfinite(res.U).all())
            and bool(torch.isfinite(res.V).all())):
        fail(f"{label}: not converged to the prescribed sigma")
    row = {"iters": it, "passes": p, "bytes_per_pass": bpp,
           "wall_s": res.wall_time_s, "s_per_pass": per_pass,
           "bound_s_per_pass": bound, "launches": routes,
           "sigma_err": err}
    if profile:
        _, prof = copy_profile(torch, lambda: repro_torch.svd(X, K, **kw))
        w = prof["wall_s"]
        print(f"  profile of a second {label} solve: {w:.3f} s, device busy "
              f"{prof['busy_s']:.3f} s ({100 * prof['busy_s'] / w:.1f} %), "
              f"copy engine busy {prof['copy_s']:.3f} s "
              f"({100 * prof['copy_s'] / w:.1f} %; {prof['copies']} copies, "
              + (f"{p * bpp / prof['copy_s'] / 1e9:.2f}" if prof["copy_s"]
                 else "-") + " GB/s while copying), "
              f"kernels {prof['kernel_s']:.3f} s in {prof['kernels']} "
              f"activities, of which "
              + ("-" if prof["hidden"] is None else
                 f"{100 * prof['hidden']:.1f} %") + " ran under a copy")
        row["profile"] = prof
    return row


def host_spectral(torch, H, seed, dev):
    """``U diag(s) V^T + NOISE * G`` of the shape of the host array ``H``,
    built on the card one 1 GiB row chunk at a time from a shared
    orthonormal U (m x 64) and V, each chunk copied into ``H``; returns
    the prescribed s."""
    m, n = H.shape
    g = torch.Generator(device=dev).manual_seed(seed)
    s = (100.0 * 0.9 ** torch.arange(N_SPECTRUM, dtype=torch.float64)
         ).to(torch.float32).to(dev)
    U = torch.linalg.qr(torch.randn(m, N_SPECTRUM, generator=g,
                                    device=dev)).Q
    V = torch.linalg.qr(torch.randn(n, N_SPECTRUM, generator=g,
                                    device=dev)).Q
    Ht = torch.from_numpy(H)
    step = max(1, (1 << 28) // n)
    chunk = torch.empty((step, n), device=dev)
    for r in range(0, m, step):
        rows = min(step, m - r)
        blk = chunk[:rows]
        torch.matmul(U[r:r + rows] * s, V.mT, out=blk)
        blk.add_(torch.randn((rows, n), generator=g, device=dev),
                 alpha=NOISE)
        Ht[r:r + rows].copy_(blk)
    return s


def to_host(torch, A, out=None):
    """A card tensor copied into a numpy array (``out`` when given)."""
    import numpy as np
    if out is None:
        out = np.empty(tuple(A.shape), np.float32)
    torch.from_numpy(out).copy_(A)
    return out


def drop_page_cache(path) -> None:
    """Write ``path`` out and drop it from the OS page cache, so the next
    read comes from the disk."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


def sigma_err(torch, got, want) -> float:
    return float((got.double().cpu() / want.double().cpu() - 1).abs().max())


def out_of_core(torch, repro_torch, ops, dev) -> dict:
    """Phase 8: the host-blocked and disk tiers (see the module
    docstring); returns its numbers for the JSON line."""
    import tempfile

    import numpy as np
    from repro_torch.core import (CountingHostMatrix, FaultPlan, FaultSpec,
                                  HostBlockedMatrix, MemmapMatrix,
                                  inject_faults, stage_to_disk, staging)
    out: dict = {}
    t_phase = time.perf_counter()
    out["host"] = lim = host_limits()
    print(f"host: {lim['mem_total'] / 2**30:.1f} GiB of memory "
          f"({lim['mem_available'] / 2**30:.1f} available, page cache "
          f"{lim['page_cache'] / 2**30:.1f}), locked-memory limit "
          + ("unlimited" if lim["memlock"] is None else
             f"{lim['memlock']} bytes")
          + f", {lim['cpus']} CPUs, temp directory {lim['tmp']} with "
          f"{lim['tmp_free'] / 2**30:.1f} GiB free")
    if lim["mem_available"] < OOC_ROWS * N * 4 * 1.05:
        fail(f"the host cannot hold the {OOC_ROWS}x{N} fp32 input "
             f"({OOC_ROWS * N * 4 / 2**30:.0f} GiB) and its registration: "
             f"{lim['mem_available'] / 2**30:.1f} GiB available")

    # -- 8.1 the tier's bound -------------------------------------------
    t0 = time.perf_counter()
    out["h2d"] = rates = h2d_rates(torch, staging, dev)
    pinned = rates["pinned"]
    print(f"8.1 host -> device, 2 GiB, best (median) of {H2D_REPS}: "
          + ", ".join(f"{lab} {rates[lab] / 1e9:.2f} "
                      f"({rates[lab + '_median'] / 1e9:.2f}) GB/s"
                      for lab in ("pinned", "pageable", "ring", "pitched"))
          + f"; the best pinned rate is the out-of-core tiers' bound; the "
          f"ring's copies are rows of 32 KiB (one run), the pitched ones "
          f"rows of 8191 fp32 into rows of 8192; "
          f"{time.perf_counter() - t0:.1f} s")
    # staging.cu's row: the ring's copy against the link's bound and the
    # plain version, one copy_ from pinned (itself the one PyTorch call)
    nbytes = H2D_PROBE * 4
    out["staging_row"] = row = {
        "name": "repro_h2d_pitched (H2DRing)", "ms": nbytes / rates["ring"]
        * 1e3, "plain_ms": nbytes / pinned * 1e3, "bound_ms": nbytes /
        PCIE_PEAK * 1e3, "bound_by": "bytes", "library_ms": None}
    print(f"  staging.cu row, 2 GiB: ring {row['ms']:.3f} ms, plain "
          f"(copy_ from pinned) {row['plain_ms']:.3f} ms, bound "
          f"{row['bound_ms']:.3f} ms (bytes at the link's "
          f"{PCIE_PEAK / 1e9:.0f} GB/s); the ring at "
          f"{row['bound_ms'] / row['ms']:.1%} of its bound")

    # -- 8.2 the paper's per-node shard in host memory --------------------
    t0 = time.perf_counter()
    H = np.empty((OOC_ROWS, N), np.float32)    # item 3's; item 2 its head
    A, s = spectral_matrix(torch, M, N, SEED, dev)
    dense32 = repro_torch.svd(A, K).S
    dense16 = repro_torch.svd(A, K, sweep_dtype="bfloat16", eps=1e-4).S
    Ah = H[:M]
    t1 = time.perf_counter()
    to_host(torch, A, Ah)
    del A
    torch.cuda.empty_cache()
    print(f"8.2 A {M}x{N} fp32 built on the card (seed {SEED}, phase 3's), "
          f"solved there for reference, copied into host memory in "
          f"{time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    hb = CountingHostMatrix(Ah, OOC_BLOCKS)
    print(f"  CountingHostMatrix(A, {OOC_BLOCKS}): {Ah.nbytes / 2**30:.0f} "
          f"GiB page-locked in place in {time.perf_counter() - t1:.1f} s")
    out["fp32"] = hb_solve(torch, repro_torch, ops, hb,
                           f"svd(CountingHostMatrix(A, {OOC_BLOCKS}), {K}) "
                           f"fp32", s, dense32, pinned, profile=True)
    hb.close()
    t1 = time.perf_counter()
    hb = CountingHostMatrix(Ah, OOC_BLOCKS, stage_dtype="bfloat16")
    print(f"  CountingHostMatrix(A, {OOC_BLOCKS}, stage_dtype='bfloat16'): "
          f"staged into pinned bf16 blocks in {time.perf_counter() - t1:.1f}"
          f" s")
    out["bf16"] = hb_solve(torch, repro_torch, ops, hb,
                           f"svd(CountingHostMatrix(A, {OOC_BLOCKS}, bf16), "
                           f"{K}) bf16 sweeps", s, dense16, pinned, rtol=1e-2,
                           chains="wgmma", profile=True,
                           sweep_dtype="bfloat16", eps=1e-4)
    hb.close()
    del hb, Ah
    print(f"  8.2: {time.perf_counter() - t0:.1f} s")

    # -- 8.3 out of memory for real ----------------------------------------
    t0 = time.perf_counter()
    s3 = host_spectral(torch, H, SEED + 12, dev)
    torch.cuda.synchronize()
    print(f"8.3 A {OOC_ROWS}x{N} fp32 ({H.nbytes / 1e9:.1f} GB, more than "
          f"the card's {torch.cuda.get_device_properties(0).total_memory / 1e9:.1f}"
          f" GB) built row block by row block into host memory in "
          f"{time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    keep = HostBlockedMatrix(H, OOC_BLOCKS)    # the registration, timed
    print(f"  {H.nbytes / 2**30:.0f} GiB page-locked in place in "
          f"{time.perf_counter() - t1:.1f} s (svd's own matrix below shares "
          f"the registration)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out["oom"] = hb_solve(torch, repro_torch, ops, H,
                          f"svd(A {OOC_ROWS}x{N} numpy, {K}) fp32", s3,
                          s3[:K], pinned)
    peak = torch.cuda.max_memory_allocated()
    blk = -(-OOC_ROWS // OOC_BLOCKS) * N * 4
    out["oom"]["peak_device_bytes"] = peak
    print(f"  peak device memory during the solve {peak / 1e9:.2f} GB, "
          f"below A's {H.nbytes / 1e9:.1f} GB: two blocks are "
          f"{2 * blk / 1e9:.2f} GB")
    if not peak < H.nbytes:
        fail(f"8.3: peak device memory {peak} is not below A's {H.nbytes}")
    keep.close()
    del keep, H
    print(f"  8.3: {time.perf_counter() - t0:.1f} s")

    # -- 8.4 gram-free on host blocks ----------------------------------------
    t0 = time.perf_counter()
    Ag, sg = spectral_matrix(torch, M, N_GRAM, SEED + 4, dev)
    Agh = to_host(torch, Ag)
    hb = CountingHostMatrix(Agh, OOC_BLOCKS)
    ops.reset_launches()
    res = repro_torch.svd(hb, K_OOC_GRAMFREE, method="gramfree")
    counts = {n: c for n, c in ops.launches.items() if c}
    it = [int(i) for i in res.iters]
    p = res.passes_over_A
    err = sigma_err(torch, res.S, sg[:K_OOC_GRAMFREE])
    print(f"8.4 svd(CountingHostMatrix(A {M}x{N_GRAM}, {OOC_BLOCKS}), "
          f"{K_OOC_GRAMFREE}, method='gramfree'): iters per rank {it}, "
          f"passes_over_A {p}, fetches {hb.fetches}, wall_time_s "
          f"{res.wall_time_s:.3f}, {res.wall_time_s / p:.4f} s a pass "
          f"against {res.bytes_per_pass / pinned:.4f} at the pinned rate, "
          f"launches {counts}, max sigma rel err {err:.2e} (limit "
          f"{TOL_DEFLATION:.0e})")
    want = {"matvec": OOC_BLOCKS * (sum(it) + len(it)),
            "deflate_rmatvec": OOC_BLOCKS * sum(it)}
    if (res.backend != "hostblocked" or p != sum(2 * i + 1 for i in it)
            or hb.fetches != p * OOC_BLOCKS or counts != want
            or res.bytes_moved is not None):
        fail(f"8.4: backend {res.backend}, passes {p}, fetches {hb.fetches}, "
             f"launches {counts} (want {want})")
    if not (res.converged and err <= TOL_DEFLATION):
        fail("8.4: not converged to the prescribed sigma")
    out["gramfree"] = {"iters": it, "passes": p, "wall_s": res.wall_time_s,
                       "launches": counts, "sigma_err": err}

    # -- 8.5 the streamed Gram -------------------------------------------
    ops.reset_launches()
    t1 = time.perf_counter()
    B = hb.gram()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    ran = {n: c for n, c in ops.route_launches.items() if c}
    whole = ops.gram(Ag)
    e = rel_err(torch, B, whole)
    off = gram_offdiag_err(torch, B, whole)
    print(f"8.5 HostBlockedMatrix(A, {OOC_BLOCKS}).gram() {M}x{N_GRAM}: "
          f"{secs:.3f} s (one pass, {hb.bytes_per_pass / pinned:.3f} s at "
          f"the pinned rate), launches by route {ran}; against ops.gram of "
          f"the whole A on the card: rel err {e:.2e} (limit "
          f"{gram_tol(M):.1e}), off the diagonal {off:.2e} (limit "
          f"{TOL_GRAM_OFFDIAG:.0e}), exactly symmetric "
          f"{bool(torch.equal(B, B.mT))}")
    if (ran != {"gram/tf32x3": OOC_BLOCKS} or not e <= gram_tol(M)
            or outside(off, TOL_GRAM_OFFDIAG) or not torch.equal(B, B.mT)):
        fail("8.5: the streamed Gram")
    out["gram"] = {"s": secs, "rel_err": e, "offdiag_err": off,
                   "launches": ran}
    hb.close()
    del hb, B, whole, Ag
    torch.cuda.empty_cache()
    print(f"  8.4-8.5: {time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        saved, tempfile.tempdir = tempfile.tempdir, tmp  # demotion spills
        try:
            del Agh
            Ad, sd6 = spectral_matrix(torch, DISK_ROWS, N_GRAM, SEED + 8,
                                      dev)
            Adh = to_host(torch, Ad)
            del Ad
            torch.cuda.empty_cache()
            out["disk"] = disk_tier(torch, repro_torch, stage_to_disk,
                                    MemmapMatrix, Adh, sd6, pinned, tmp)
            del Adh
            out["odd"] = odd_width(torch, repro_torch, ops, pinned, dev)
            out["demote"] = demotion(torch, repro_torch, inject_faults,
                                     FaultPlan, FaultSpec, dev)
        finally:
            tempfile.tempdir = saved
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 8: {out['seconds']:.1f} s")
    return out


def disk_tier(torch, repro_torch, stage_to_disk, MemmapMatrix, A, s,
              pinned, tmp) -> dict:
    """8.6: ``A`` staged to ``tmp`` in fp32 and bf16, then ``svd(path,
    K_DISK)`` with an unbounded host budget (disk bytes = one file read)
    and with half the file (disk bytes = passes x file bytes, the cache
    never above the budget), bf16 halving disk and H2D bytes."""
    t0 = time.perf_counter()
    paths = {sd: stage_to_disk(A, os.path.join(tmp, f"A_{sd}.npy"), dtype=sd)
             for sd in ("float32", "bfloat16")}
    for p in paths.values():
        drop_page_cache(p)
    file_bytes = {sd: A.size * (4 if sd == "float32" else 2)
                  for sd in paths}
    print(f"8.6 A {A.shape[0]}x{A.shape[1]} staged to {tmp} in fp32 and bf16 "
          f"({sum(file_bytes.values()) / 1e9:.1f} GB) in "
          f"{time.perf_counter() - t0:.1f} s, then dropped from the page "
          f"cache")
    rows = {}
    for label, sd, budget in (("fp32, unbounded host budget", "float32", 0),
                              ("fp32, half the file", "float32",
                               file_bytes["float32"] // 2),
                              ("bf16, half the file", "bfloat16",
                               file_bytes["bfloat16"] // 2)):
        kw = {"sweep_dtype": sd, "eps": 1e-4} if sd == "bfloat16" else {}
        rtol = 1e-2 if sd == "bfloat16" else 1e-4
        drop_page_cache(paths[sd])
        cached0 = host_limits()["page_cache"]
        if budget == 0:
            mm = None
            res = repro_torch.svd(paths[sd], K_DISK, **kw)
        else:
            mm = MemmapMatrix(paths[sd], OOC_BLOCKS, stage_dtype=sd,
                              host_budget_bytes=budget)
            res = repro_torch.svd(mm, K_DISK, **kw)
        cached = host_limits()["page_cache"] - cached0
        p, moved = res.passes_over_A, res.bytes_moved
        err = sigma_err(torch, res.S, s[:K_DISK])
        peak = None if mm is None else mm.peak_host_bytes
        print(f"  svd({'path' if mm is None else 'MemmapMatrix(path)'}, "
              f"{K_DISK}) {label}: backend {res.backend}, iters "
              f"{int(res.iters[0])}, passes {p}, bytes_moved {moved}, "
              f"peak host cache {peak}, wall_time_s {res.wall_time_s:.3f}, "
              f"{res.wall_time_s / p:.4f} s a pass ("
              f"{res.bytes_per_pass / pinned:.4f} at the pinned rate), max "
              f"sigma rel err {err:.2e} (limit {rtol:.0e}); the page cache "
              f"grew by {cached / 1e9:.2f} GB: the first pass read the disk, "
              + ("the cache held the rest" if budget == 0 else
                 "later passes read the file again from the page cache"))
        want_disk = file_bytes[sd] * (1 if budget == 0 else p)
        if (res.backend != "memmap" or moved["disk"] != want_disk
                or moved["host"] != p * res.bytes_per_pass
                or moved["device"] != moved["host"]
                or (peak is not None and not 0 < peak <= budget)):
            fail(f"8.6 {label}: bytes_moved {moved} (disk should be "
                 f"{want_disk}), peak host cache {peak} of {budget}")
        if not (res.converged and err <= rtol):
            fail(f"8.6 {label}: not converged to the prescribed sigma")
        rows[label] = {"passes": p, "bytes_moved": moved,
                       "wall_s": res.wall_time_s, "peak_host": peak,
                       "page_cache_growth": cached}
        del mm
    f32, f16 = rows["fp32, half the file"], rows["bf16, half the file"]
    if (f16["bytes_moved"]["disk"] * 2 * f32["passes"]
            != f32["bytes_moved"]["disk"] * f16["passes"]
            or f16["bytes_moved"]["host"] * 2 * f32["passes"]
            != f32["bytes_moved"]["host"] * f16["passes"]):
        fail("8.6: bf16 does not halve the disk and H2D bytes a pass")
    print(f"  8.6: bf16 moves half the disk and H2D bytes a pass; "
          f"{time.perf_counter() - t0:.1f} s")
    return rows


def odd_width(torch, repro_torch, ops, pinned, dev) -> dict:
    """8.7: 65536 x 8191 fp32 in host memory, and a bf16-staged copy of
    it: the blocks' device rows padded to 8192, so the chains run
    ``tf32x3`` and ``wgmma`` (never a cp.async route), sigma equal to the
    dense solve of the same input."""
    from repro_torch.core import CountingHostMatrix
    t0 = time.perf_counter()
    A, s = spectral_matrix(torch, *ODD_LDA, SEED + 10, dev)
    Ah = to_host(torch, A)
    rows = {}
    for sd, chains, rtol in (("float32", "tf32x3", 1e-4),
                             ("bfloat16", "wgmma", 1e-2)):
        kw = {"sweep_dtype": sd, "eps": 1e-4} if sd == "bfloat16" else {}
        dense = repro_torch.svd(A, K, **kw).S
        hb = CountingHostMatrix(Ah, OOC_BLOCKS, stage_dtype=sd)
        rows[sd] = hb_solve(torch, repro_torch, ops, hb,
                            f"8.7 odd width svd(CountingHostMatrix(A "
                            f"{ODD_LDA[0]}x{ODD_LDA[1]}, {OOC_BLOCKS}, {sd}), "
                            f"{K})", s, dense, pinned, rtol=rtol,
                            chains=chains, **kw)
        hb.close()
    del A
    torch.cuda.empty_cache()
    print(f"  8.7: {time.perf_counter() - t0:.1f} s")
    return rows


def demotion(torch, repro_torch, inject_faults, FaultPlan, FaultSpec,
             dev) -> dict:
    """8.8: a device OOM (``FaultSpec("device_oom", at=3)``) on the dense
    tier finishes on the host-blocked one, and on the host-blocked tier
    on the disk tier, from the warm iterate, sigma within 1e-4 of the
    clean solve; under ``force_iters`` the iterations are the clean
    solve's and the passes each tier's count (dense 2 an iteration, the
    streamed tiers 1)."""
    t0 = time.perf_counter()
    A, _ = spectral_matrix(torch, *DEMOTE, SEED + 13, dev)
    Ah = A.cpu().numpy()
    fault = lambda: inject_faults(FaultPlan(FaultSpec("device_oom", at=3)))
    rows = {}
    forced = {"force_iters": True, "max_iters": DEMOTE_ITERS}
    for X, frm, to, tier_passes in ((A, "dense", "hostblocked", 2),
                                    (Ah, "hostblocked", "memmap", 1)):
        clean = repro_torch.svd(X, K)
        with fault():
            hit = repro_torch.svd(X, K)
        clean_f = repro_torch.svd(X, K, **forced)
        with fault():
            hit_f = repro_torch.svd(X, K, **forced)
        err = sigma_err(torch, hit.S, clean.S)
        err_f = sigma_err(torch, hit_f.S, clean_f.S)
        want_f = tier_passes * 3 + (DEMOTE_ITERS - 3) + 1
        print(f"8.8 svd({frm} {DEMOTE[0]}x{DEMOTE[1]}, {K}) under a device "
              f"OOM at step 3: finished on {hit.backend} (faults "
              f"{hit.faults['counters']}), max sigma rel err against the "
              f"clean solve {err:.2e}; force_iters {DEMOTE_ITERS}: backend "
              f"{hit_f.backend}, iters {int(hit_f.iters[0])}, passes "
              f"{hit_f.passes_over_A} (clean {clean_f.passes_over_A}, the "
              f"tiers' count {want_f}), sigma {err_f:.2e}")
        if (hit.backend != to or hit_f.backend != to or err > 1e-4
                or err_f > 1e-4 or int(hit_f.iters[0]) != DEMOTE_ITERS
                or hit_f.passes_over_A != want_f
                or hit.faults["counters"].get("device_oom.demote") != 1):
            fail(f"8.8: the demotion {frm} -> {to}")
        rows[frm] = {"to": hit.backend, "sigma_err": err,
                     "passes_forced": hit_f.passes_over_A,
                     "clean_passes_forced": clean_f.passes_over_A}
    del A
    torch.cuda.empty_cache()
    print(f"  8.8: {time.perf_counter() - t0:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# phase 9: the paper's sparse stream on the CSR kernels, and resume
# ---------------------------------------------------------------------------

SP_N = 33_554_432                      # the paper's per-node share, m = n
SP_ROW = 33                            # nonzeros a row: density 9.8e-7
SP_K, SP_ITERS = 8, 3                  # forced iterations: 4 passes a solve
SP_BLOCK = 1 << 16                     # SVDConfig's default block_rows
SP_CHECK_K = 8                         # the kernels' checks at the path's k
# the kernels' check blocks: the first, and the ragged last rows
# [m - (2^16 - 4099), m) of a blocking whose rows do not divide m (a
# middle block, a full one like the first, was dropped to keep the
# script inside its time limit)
SP_RAGGED = SP_BLOCK - 4099
SPEC_N = 1 << 22                       # the known spectrum's matrix
SPEC_SCALE = 1e-6
K_SPEC, K_SPEC_GRAMFREE = 32, 2
RESUME_CAP = 8                         # max_iters of the capped solves
CSR_SOURCE = "src/repro_torch/csrc/csr_sweep.cu"
HOST_SWEEP = "src/repro/core/sparse.py"  # the np.add.at it replaces
CSR_REPLACES = {"csr_matmat": f"{HOST_SWEEP}:109",
                "csr_rmatmat": f"{HOST_SWEEP}:120",
                "csr_gram_chain": f"{HOST_SWEEP}:162"}
CSR_GATHER_BYTES = 1 << 30             # the random-row ceiling's array
CSR_LIBRARY = {"csr_matmat": "torch.sparse.mm(A_b, Q) (cuSPARSE, CSR)",
               "csr_rmatmat": "torch.sparse.mm(A_b^T, Y) (cuSPARSE; A_b^T "
                              "converted to CSR outside the timing)",
               "csr_gram_chain": "the two calls above"}


def _host_sweep(np, off, col, val, X, transpose, Z0=None, round_y=None):
    """``np.add.at`` in stream order over one block: ``A_b X`` (rows, k),
    or ``A_b^T X`` on the block's distinct columns (added to ``Z0`` there
    when given); the JAX package's host sweep.  Returns (columns, sums)
    for ``transpose``."""
    rows = np.repeat(np.arange(len(off) - 1), np.diff(off))
    if not transpose:
        out = np.zeros((len(off) - 1, X.shape[1]), np.float32)
        np.add.at(out, rows, val[:, None] * X[col])
        return round_y(out) if round_y is not None else out
    uniq, inv = np.unique(col, return_inverse=True)
    out = np.zeros((uniq.size, X.shape[1]), np.float32) if Z0 is None \
        else Z0.copy()
    np.add.at(out, inv, val[:, None] * X[rows])
    return uniq, out


def csr_ceiling(torch, csr, count: int, dev) -> dict:
    """The random-row ceiling: ``row_gather`` of ``count`` uniformly random
    32-byte rows of a 1 GiB fp32 array (CUDA events, warm): ms, and ms a
    row."""
    src = torch.empty((CSR_GATHER_BYTES // 32, 8), dtype=torch.float32,
                      device=dev).normal_()
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    idx = torch.randint(0, src.shape[0], (count,), generator=g, device=dev,
                        dtype=torch.int32)
    ms = time_ms(torch, lambda: csr.row_gather_cuda(src, idx), 20)
    del src, idx
    return {"rows": count, "ms": ms, "ms_a_row": ms / count,
            "bytes_per_s": count * 32 / ms * 1e3}


def csr_library(torch, key, A, At, Qd, Yd):
    """One ``torch.sparse.mm`` call of the same function (``None`` for
    the chain's two calls, timed as one), or the error it raises."""
    try:
        fn = {"csr_matmat": lambda: torch.sparse.mm(A, Qd),
              "csr_rmatmat": lambda: torch.sparse.mm(At, Yd),
              "csr_gram_chain": lambda: torch.sparse.mm(
                  At, torch.sparse.mm(A, Qd))}[key]
        fn()
        torch.cuda.synchronize()
        return fn, None
    except (RuntimeError, NotImplementedError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def csr_kernel_rows(torch, ops, ref, sp, dev) -> dict:
    """The CSR kernels at the paper's per-node share, k = 8: on the first,
    the ragged last row block, and the first block with
    every nonzero moved to one column (one run as long as the block),
    fp32 and bf16 values, each held bitwise against ``np.add.at`` in this
    script (``A_b Q``; ``Z += A_b^T Y`` into a nonzero Z; the chain, y
    rounded to bf16 under bf16), the untouched rows of Z still zero, and
    rerun bitwise; timed on the first block beside the plain version
    (``index_add_`` on the card), ``torch.sparse.mm`` (bf16 values where
    the card's cuSPARSE takes them, with bf16 Q and Y: bf16 out) and the
    bound, with ``csr_rmatmat``'s sort and run halves timed apart and
    each kernel read against the random-row ceiling (``csr_ceiling``);
    the long run timed alone.  Returns the rows of the kernels line by
    name."""
    import importlib
    import numpy as np
    from repro_torch.core.sparse import _bf16_bits
    csr = importlib.import_module("repro_torch.kernels.csr_sweep")
    m, n, k = sp.m, sp.n, SP_CHECK_K
    rng = np.random.default_rng(SEED + 20)
    Q = rng.standard_normal((n, k)).astype(np.float32)
    blocks = ((0, SP_BLOCK), (m - SP_RAGGED, m), (0, SP_BLOCK))
    long_run = len(blocks) - 1          # its columns all n // 3
    rows, ceiling = {}, None
    for sd in (torch.float32, torch.bfloat16):
        name_sd = "float32" if sd == torch.float32 else "bfloat16"

        def rnd(x):
            return x if sd == torch.float32 else (
                _bf16_bits(x).astype(np.uint32) << 16).view(np.float32)
        Qs = rnd(Q)
        Qd = torch.from_numpy(Qs).to(dev)
        first = None
        for bi, (lo, hi) in enumerate(blocks):
            if bi == long_run:              # the first block's, one column
                off, col, val = first
                col = np.full_like(col, n // 3)
            else:
                off, col, val = sp._csr_block(lo, hi)
                first = first or (off, col, val)
            off32, col32, vals = off.astype(np.int32), col.astype(np.int32), \
                rnd(val)
            o, c = (torch.from_numpy(x).to(dev) for x in (off32, col32))
            v = torch.from_numpy(vals).to(dev).to(sd)
            Ys = rnd(rng.standard_normal((hi - lo, k)).astype(np.float32))
            Yd = torch.from_numpy(Ys).to(dev)
            uniq = np.unique(col32)
            Z0 = rng.standard_normal((uniq.size, k)).astype(np.float32)
            t0 = time.perf_counter()
            want_y = _host_sweep(np, off32, col32, vals, Qs, False)
            _, want_z = _host_sweep(np, off32, col32, vals, Ys, True, Z0)
            y_r = want_y if sd == torch.float32 else _host_sweep(
                np, off32, col32, vals, Qs, False, round_y=rnd)
            _, want_c = _host_sweep(np, off32, col32, vals, y_r, True, Z0)
            t_np = time.perf_counter() - t0
            ui = torch.from_numpy(uniq.astype(np.int64)).to(dev)
            untouched = torch.ones((n,), dtype=torch.bool, device=dev)
            untouched[ui] = False
            outs = []
            for _ in range(2):                    # the rerun must match
                Z = torch.zeros((n, k), device=dev)
                Z[ui] = torch.from_numpy(Z0).to(dev)
                Zc = Z.clone()
                y = ops.csr_matmat(o, c, v, Qd)
                ops.csr_rmatmat(o, c, v, Yd, Z)
                ops.csr_gram_chain(o, c, v, Qd, Zc,
                                   round_y=sd == torch.bfloat16)
                torch.cuda.synchronize()
                outs.append((y.cpu().numpy(), Z[ui].cpu().numpy(),
                             Zc[ui].cpu().numpy(),
                             int(torch.count_nonzero(Z[untouched])),
                             int(torch.count_nonzero(Zc[untouched]))))
                del Z, Zc
            (gy, gz, gc, rest_z, rest_c), again = outs
            same = all(np.array_equal(a, b) for a, b in zip(outs[0][:3],
                                                            again[:3]))
            exact = {"csr_matmat": np.array_equal(gy, want_y),
                     "csr_rmatmat": np.array_equal(gz, want_z),
                     "csr_gram_chain": np.array_equal(gc, want_c)}
            errs = {"csr_matmat": float(np.abs(gy - want_y).max()),
                    "csr_rmatmat": float(np.abs(gz - want_z).max()),
                    "csr_gram_chain": float(np.abs(gc - want_c).max())}
            what = "long run (every nonzero in one column)" \
                if bi == long_run else f"[{lo}, {hi})"
            print(f"  csr block {what} {name_sd}: {col.size} "
                  f"nonzeros, {uniq.size} columns; bitwise np.add.at "
                  f"{exact} (max |diff| {errs}); untouched rows of Z stay "
                  f"0: {rest_z == 0 and rest_c == 0}; rerun bitwise "
                  f"{same}; the numpy oracle {t_np:.1f} s")
            if not (all(exact.values()) and same and rest_z == 0
                    and rest_c == 0):
                fail(f"csr kernels on block {what} {name_sd}: "
                     f"bitwise {exact}, rerun {same}, rest {rest_z}, "
                     f"{rest_c}")
            tag = "" if sd == torch.float32 else "[bf16]"
            if bi:                        # the worst of the blocks
                for key, e in errs.items():
                    row = rows[key + tag]
                    row["max_abs_err"] = max(row["max_abs_err"], e)
            if bi == long_run:
                Zt = torch.zeros((n, k), device=dev)
                t_run = {"csr_matmat": time_ms(
                    torch, lambda: ops.csr_matmat(o, c, v, Qd), 3),
                    "csr_rmatmat": time_ms(
                    torch, lambda: ops.csr_rmatmat(o, c, v, Yd, Zt), 3)}
                for key, t in t_run.items():
                    rows[key + tag]["long_run_ms"] = t
                print(f"  long run {name_sd}: csr_matmat "
                      f"{t_run['csr_matmat']:.3f} ms, csr_rmatmat "
                      f"{t_run['csr_rmatmat']:.3f} ms "
                      f"({col.size} ordered adds a column)")
                del Zt
            if bi:
                continue
            # timing on the first block: kernel, plain, library, bound
            nnz, isz = col.size, vals.itemsize if sd == torch.float32 else 2
            if ceiling is None:
                ceiling = csr_ceiling(torch, csr, nnz, dev)
                print(f"  the random-row ceiling: row_gather of {nnz} "
                      f"uniformly random 32-byte rows of a 1 GiB fp32 array "
                      f"{ceiling['ms']:.4f} ms, "
                      f"{ceiling['bytes_per_s'] / 1e12:.3f} TB/s (the byte "
                      f"bound's rate: {PEAK_BYTES / 1e12:.2f})")
            csr_bytes = 4 * (off.size + nnz) + isz * nnz
            touched = uniq.size * k * 4
            Zt = torch.zeros((n, k), device=dev)
            v32 = v.to(torch.float32)
            A = torch.sparse_csr_tensor(o, c, v32, (hi - lo, n))
            rowid = ref.csr_rows(o, c.numel())
            At = torch.sparse_coo_tensor(
                torch.stack([c.long(), rowid]), v32,
                (n, hi - lo)).coalesce().to_sparse_csr()
            if sd == torch.bfloat16:        # the same structure, bf16 values
                A, At = (torch.sparse_csr_tensor(
                    X.crow_indices(), X.col_indices(), X.values().to(sd),
                    X.shape) for X in (A, At))
            lib, lib_err = {}, {}
            for key in CSR_REPLACES:
                if sd == torch.float32:
                    lib[key], lib_err[key] = csr_library(
                        torch, key, A, At, Qd, Yd)
                else:                   # bf16 values, Q and Y: bf16 out
                    lib[key], lib_err[key] = csr_library(
                        torch, key, A, At, Qd.to(sd), Yd.to(sd))
            if sd == torch.bfloat16:
                print("  torch.sparse.mm with bf16 CSR values on the card: "
                      + ("takes them (bf16 Q and Y, bf16 out)" if
                         all(f is not None for f in lib.values()) else
                         f"raises: {lib_err}"))
            scratch = csr.rmatmat_scratch(nnz, n, dev)
            halves = {
                "sort": time_ms(torch, lambda: csr.csr_rmatmat_cuda(
                    o, c, v, Yd, Zt, scratch=scratch, phases=csr.SORT), 20),
                "runs": time_ms(torch, lambda: csr.csr_rmatmat_cuda(
                    o, c, v, Yd, Zt, scratch=scratch, phases=csr.RUNS), 20)}
            del scratch
            fns = {
                "csr_matmat": (lambda: ops.csr_matmat(o, c, v, Qd),
                               lambda: ref.csr_matmat_ref(o, c, v, Qd),
                               csr_bytes + touched + (hi - lo) * k * 4,
                               nnz),
                "csr_rmatmat": (lambda: ops.csr_rmatmat(o, c, v, Yd, Zt),
                                lambda: ref.csr_rmatmat_ref(o, c, v, Yd, Zt),
                                csr_bytes + (hi - lo) * k * 4 + 2 * touched,
                                2 * uniq.size),
                "csr_gram_chain": (
                    lambda: ops.csr_gram_chain(o, c, v, Qd, Zt,
                                               round_y=sd == torch.bfloat16),
                    lambda: ref.csr_gram_chain_ref(
                        o, c, v, Qd, Zt, sd == torch.bfloat16),
                    csr_bytes + touched + 2 * touched,
                    nnz + 2 * uniq.size)}
            for key, (kern, plain, nbytes, scattered) in fns.items():
                flop = (4 if key == "csr_gram_chain" else 2) * nnz * k
                row = {"max_abs_err": errs[key], "nnz": nnz,
                       "columns": int(uniq.size), "dtype": name_sd,
                       "ms": time_ms(torch, kern, 20),
                       "plain_ms": time_ms(torch, plain, 3),
                       "library_ms": time_ms(torch, lib[key], 20)
                       if lib[key] is not None else None,
                       "ceiling_ms": scattered * ceiling["ms_a_row"]}
                if key == "csr_rmatmat":
                    row["sort_ms"], row["runs_ms"] = halves["sort"], \
                        halves["runs"]
                row["bound_ms"], row["bound_by"] = pick(
                    nbytes / PEAK_BYTES * 1e3,
                    flop / PEAK_OPS["float32"] * 1e3)
                label = key + tag
                rows[label] = row
                print(f"  {label:22s}: block [{lo}, {hi}), k = {k}: kernel "
                      f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
                      f"library " + ("-" if row["library_ms"] is None else
                                     f"{row['library_ms']:.3f} ms ("
                                     f"{CSR_LIBRARY[key]})")
                      + f", bound {row['bound_ms']:.3f} ms "
                      f"({row['bound_by']}: {nbytes} bytes; "
                      f"{100 * row['bound_ms'] / row['ms']:.0f} %), "
                      f"random-row ceiling {row['ceiling_ms']:.3f} ms ("
                      f"{scattered} rows; "
                      f"{100 * row['ceiling_ms'] / row['ms']:.0f} %)" + (
                          f"; the sort half (records, the radix pass, the "
                          f"bucket sorts, the run list) {halves['sort']:.3f}"
                          f" ms, the sum half (the runs) "
                          f"{halves['runs']:.3f} ms"
                          if key == "csr_rmatmat" else ""))
            del Zt, lib, A, At
            torch.cuda.empty_cache()
    return rows


def sparse_profile(torch, fn) -> tuple:
    """``fn()`` under ``torch.profiler``: its result and wall seconds,
    device busy (any kernel or copy), copy engine busy, the CSR kernels'
    time (``csr_matmat``, ``csr_records``, ``csr_bucket_*``, ``csr_runs``,
    ``csr_big_buckets``), their radix passes' (CUB's kernels) and the
    rest's."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = {"copy": [], "csr": [], "sort": [], "other": []}
    other: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        iv = (e.time_range.start / 1e6, e.time_range.end / 1e6)
        name = e.name.lower()
        key = ("copy" if "memcpy" in name else
               "csr" if any(s in name for s in (
                   "csr_matmat", "csr_records", "csr_bucket", "csr_runs",
                   "csr_big_buckets")) else
               "sort" if "sort" in name or "radix" in name else "other")
        spans[key].append(iv)
        if key == "other":
            other[e.name] = other.get(e.name, 0.0) + iv[1] - iv[0]
    allv = [iv for v in spans.values() for iv in v]
    prof_row = {"wall_s": wall, "busy_s": _length(_union(allv)),
                **{f"{k}_s": _length(_union(v)) for k, v in spans.items()},
                "activities": len(allv)}
    prof_row["idle"] = 1 - prof_row["busy_s"] / wall
    prof_row["other_top"] = sorted(other.items(), key=lambda x: -x[1])[:5]
    return out, prof_row


def paper_share(torch, repro_torch, ops, sp, sd, rate, profile) -> dict:
    """``svd(sp, 8, force_iters=True, max_iters=3)`` at ``sd``: passes
    4, launches 512 x passes by kernel, ``bytes_moved`` exact; seconds a
    pass split into the host's packing rate, H2D and kernels."""
    nb = -(-sp.m // SP_BLOCK)
    label = f"paper share svd(sp, {SP_K}) {sd}"
    sp.reset_feed_stats()
    ops.reset_launches()
    kw = dict(force_iters=True, max_iters=SP_ITERS, sweep_dtype=sd)
    if profile:
        res, prof = sparse_profile(torch, lambda: repro_torch.svd(
            sp, SP_K, **kw))
    else:
        res, prof = repro_torch.svd(sp, SP_K, **kw), None
    counts = {n_: c for n_, c in ops.launches.items() if c}
    routes = {n_: c for n_, c in ops.route_launches.items() if c}
    st = sp.feed_stats()
    p, bpp = res.passes_over_A, res.bytes_per_pass
    isz = 4 if sd == "float32" else 2
    want = {"csr_gram_chain": nb * SP_ITERS, "csr_matmat": nb * (SP_ITERS + 1),
            "csr_rmatmat": nb * SP_ITERS}
    tag = sd
    want_routes = {f"csr_gram_chain/{tag}": nb * SP_ITERS,
                   f"csr_rmatmat/{tag}": nb * SP_ITERS,
                   f"csr_matmat/{tag}": nb * SP_ITERS}
    want_routes["csr_matmat/float32"] = \
        want_routes.get("csr_matmat/float32", 0) + nb     # the extraction
    wall = res.wall_time_s
    per_pass = wall / p
    h2d_bound = st["pcie_bytes"] / p / rate
    row = {"passes": p, "bytes_per_pass": bpp, "bytes_moved": res.bytes_moved,
           "wall_s": wall, "s_per_pass": per_pass, "launches": routes,
           "nnz_packed": st["nnz"], "pack_thread_s": st["pack_s"],
           "wait_s": st["wait_s"], "pcie_bytes": st["pcie_bytes"],
           "nnz_per_s": st["nnz"] / wall,
           "nnz_per_thread_s": st["nnz"] / st["pack_s"],
           "h2d_gb_s": st["pcie_bytes"] / wall / 1e9,
           "h2d_bound_s_per_pass": h2d_bound}
    S = res.S.cpu()
    print(f"{label}: iters {int(res.iters[0])}, passes_over_A {p}, "
          f"bytes_per_pass {bpp} ({sp.nnz} nonzeros x {isz}), bytes_moved "
          f"{res.bytes_moved}, wall_time_s {wall:.3f}, {per_pass:.3f} s a "
          f"pass; the host packed {st['nnz']} nonzeros at "
          f"{row['nnz_per_s'] / 1e6:.1f} M/s ({row['nnz_per_thread_s'] / 1e6:.1f}"
          f" M/s a thread over {st['pack_s']:.1f} thread-s; the launching "
          f"thread waited {st['wait_s']:.1f} s for it), PCIe "
          f"{st['pcie_bytes'] / p / 1e9:.2f} GB a pass ("
          f"{row['h2d_gb_s']:.2f} GB/s over the solve; at the pinned rate "
          f"{h2d_bound:.3f} s a pass), launches {counts} (by dtype {routes}), "
          f"sigma {[round(float(x), 4) for x in S]}")
    if prof is not None:
        w = prof["wall_s"]
        kern = prof["csr_s"] + prof["sort_s"]
        row["kernels_s_per_pass"] = kern / p
        print(f"  profile: {w:.3f} s, device busy {prof['busy_s']:.3f} s "
              f"(idle {100 * prof['idle']:.1f} %), copy engine "
              f"{prof['copy_s']:.3f} s, CSR kernels {prof['csr_s']:.3f} s, "
              f"their radix passes {prof['sort_s']:.3f} s: the kernels' "
              f"device time {kern / p:.4f} s a pass beside the wall's "
              f"{w / p:.3f} s a pass; the rest "
              f"{prof['other_s']:.3f} s (" + ", ".join(
                  f"{n_[:40]} {t:.3f} s" for n_, t in prof["other_top"])
              + f"); {prof['activities']} activities")
        row["profile"] = prof
    if counts != want or routes != want_routes:
        fail(f"{label}: launches {counts} by dtype {routes}; {nb} blocks x "
             f"passes implies {want} by dtype {want_routes}")
    if p != SP_ITERS + 1 or bpp != sp.nnz * isz or \
            res.bytes_moved != {"host": p * bpp} or \
            res.backend != "sparsestream":
        fail(f"{label}: passes {p}, bytes_per_pass {bpp}, bytes_moved "
             f"{res.bytes_moved}, backend {res.backend}")
    if st["nnz"] != p * sp.nnz:
        fail(f"{label}: {st['nnz']} nonzeros packed for {p} passes")
    U, V = res.U, res.V
    eye = torch.eye(SP_K, device=U.device)
    orth = max(float((U.mT @ U - eye).abs().max()),
               float((V.mT @ V - eye).abs().max()))
    if not (bool(torch.isfinite(U).all()) and bool(torch.isfinite(V).all())
            and bool(torch.isfinite(S).all()) and bool((S > 0).all())
            and bool((S[:-1] >= S[1:]).all()) and orth < 1e-3
            and tuple(U.shape) == (sp.m, SP_K)
            and tuple(V.shape) == (sp.n, SP_K)):
        fail(f"{label}: factors not finite/orthonormal/sorted ({orth})")
    return row


def spectral_csr(np, scipy_sparse, repro_torch):
    """The known spectrum as a scipy CSR: ``SyntheticSparseMatrix(2^22,
    2^22, 33, seed=1)`` scaled by 1e-6, plus 64 entries 100 * 0.9^i at
    distinct rows and columns from seed 0."""
    base = repro_torch.SyntheticSparseMatrix(SPEC_N, SPEC_N, SP_ROW, seed=1)
    off, cols, vals = base._csr_block(0, SPEC_N)
    noise = scipy_sparse.csr_matrix(
        ((vals * np.float32(SPEC_SCALE)), cols.astype(np.int32), off),
        shape=(SPEC_N, SPEC_N))
    del off, cols, vals
    rng = np.random.default_rng(SEED)
    r = rng.choice(SPEC_N, N_SPECTRUM, replace=False)
    c = rng.choice(SPEC_N, N_SPECTRUM, replace=False)
    s = (100.0 * 0.9 ** np.arange(N_SPECTRUM)).astype(np.float32)
    spec = scipy_sparse.csr_matrix((s, (r, c)), shape=(SPEC_N, SPEC_N))
    return (noise + spec).tocsr(), s


def known_spectrum(torch, repro_torch, ops, dev, tmpdir) -> dict:
    """The scipy CSR with a known spectrum: the block solve at k = 32,
    the same matrix from a ``.npz`` path (bitwise), gram-free at k = 2,
    and the block solve capped at 8 iterations with ``checkpoint_dir``
    and resumed (bitwise, equal passes)."""
    import numpy as np
    import scipy.sparse as scipy_sparse
    out = {}
    t0 = time.perf_counter()
    A, s = spectral_csr(np, scipy_sparse, repro_torch)
    nb = -(-A.shape[0] // SP_BLOCK)
    print(f"9.3 the known spectrum: {A.shape[0]}x{A.shape[1]} CSR, {A.nnz} "
          f"nonzeros (density {A.nnz / A.shape[0] / A.shape[1]:.2e}), built "
          f"on the host in {time.perf_counter() - t0:.1f} s")
    ops.reset_launches()
    res = repro_torch.svd(A, K_SPEC)
    it = int(res.iters[0])
    err = float(np.abs(res.S.cpu().numpy() / s[:K_SPEC] - 1).max())
    counts = {n_: c for n_, c in ops.launches.items() if c}
    print(f"  block svd(A, {K_SPEC}): backend {res.backend}, iters {it}, "
          f"passes_over_A {res.passes_over_A}, bytes_moved {res.bytes_moved},"
          f" converged {res.converged}, wall_time_s {res.wall_time_s:.3f} "
          f"({res.wall_time_s / res.passes_over_A:.3f} s a pass), launches "
          f"{counts}, max sigma rel err {err:.2e} (limit 1e-4)")
    if not (res.converged and err <= 1e-4 and res.passes_over_A == it + 1
            and res.backend == "scipysparse"
            and counts == {"csr_gram_chain": nb * it,
                           "csr_matmat": nb * (it + 1),
                           "csr_rmatmat": nb * it}):
        fail("the known spectrum's block solve")
    out["block"] = {"iters": it, "passes": res.passes_over_A,
                    "wall_s": res.wall_time_s, "sigma_err": err}
    path = os.path.join(tmpdir, "A.npz")
    t0 = time.perf_counter()
    scipy_sparse.save_npz(path, A, compressed=False)
    t_save = time.perf_counter() - t0
    res_p = repro_torch.svd(path, K_SPEC)
    same = torch.equal(res_p.S, res.S)
    print(f"  svd('A.npz', {K_SPEC}) ({os.path.getsize(path) / 1e9:.2f} GB, "
          f"saved in {t_save:.1f} s): iters {int(res_p.iters[0])}, "
          f"wall_time_s {res_p.wall_time_s:.3f}, sigma bitwise equal to "
          f"the in-memory solve: {same}")
    os.remove(path)
    if not same or res_p.passes_over_A != res.passes_over_A:
        fail("svd of the .npz path differs from the in-memory solve")
    ck = os.path.join(tmpdir, "ck")
    capped = repro_torch.svd(A, K_SPEC, max_iters=RESUME_CAP,
                             checkpoint_dir=ck)
    resumed = repro_torch.svd(A, K_SPEC, checkpoint_dir=ck)
    same = all(torch.equal(a, b) for a, b in zip(resumed[:3], res[:3]))
    print(f"  resume: capped at {int(capped.iters[0])} iterations "
          f"(converged {capped.converged}), resumed to "
          f"{int(resumed.iters[0])}, passes {resumed.passes_over_A} "
          f"(uncapped {res.passes_over_A}); U, S, V bitwise equal to the "
          f"uncapped solve: {same}")
    if capped.converged or not same or \
            resumed.passes_over_A != res.passes_over_A:
        fail("the resumed sparse solve differs from the uncapped one")
    out["resume"] = {"capped_iters": int(capped.iters[0]),
                     "passes": resumed.passes_over_A, "bitwise": same}
    del res, res_p, capped, resumed
    ops.reset_launches()
    res = repro_torch.svd(A, K_SPEC_GRAMFREE, method="gramfree")
    its = [int(x) for x in res.iters]
    err = float(np.abs(res.S.cpu().numpy() / s[:K_SPEC_GRAMFREE] - 1).max())
    counts = {n_: c for n_, c in ops.launches.items() if c}
    want = {"csr_matmat": nb * sum(i + 1 for i in its),
            "csr_rmatmat": nb * sum(its)}
    print(f"  gram-free svd(A, {K_SPEC_GRAMFREE}): iters {its}, passes "
          f"{res.passes_over_A}, wall_time_s {res.wall_time_s:.3f}, launches "
          f"{counts} (want {want}), max sigma rel err {err:.2e} (limit "
          f"{TOL_DEFLATION:.0e})")
    if err > TOL_DEFLATION or res.passes_over_A != sum(2 * i + 1
                                                      for i in its) \
            or counts != want:
        fail("the known spectrum's gram-free solve")
    out["gramfree"] = {"iters": its, "passes": res.passes_over_A,
                       "wall_s": res.wall_time_s, "sigma_err": err}
    return out


def dense_resume(torch, repro_torch, dev, tmpdir) -> dict:
    """Phase 3's dense shard solved with ``checkpoint_dir`` capped at 8
    iterations and resumed: U, S, V bitwise the uncapped solve's."""
    A, s = spectral_matrix(torch, M, N, SEED, dev)
    ref = repro_torch.svd(A, K)
    ck = os.path.join(tmpdir, "ck_dense")
    capped = repro_torch.svd(A, K, max_iters=RESUME_CAP, checkpoint_dir=ck)
    resumed = repro_torch.svd(A, K, checkpoint_dir=ck)
    same = all(torch.equal(a, b) for a, b in zip(resumed[:3], ref[:3]))
    print(f"9.4 dense shard {M}x{N} resume: capped at "
          f"{int(capped.iters[0])}, resumed to {int(resumed.iters[0])} "
          f"iterations, passes {resumed.passes_over_A} (uncapped "
          f"{ref.passes_over_A}), wall {capped.wall_time_s:.3f} + "
          f"{resumed.wall_time_s:.3f} s (uncapped {ref.wall_time_s:.3f}); "
          f"U, S, V bitwise equal: {same}")
    if not same or resumed.passes_over_A != ref.passes_over_A or \
            capped.converged:
        fail("the resumed dense solve differs from the uncapped one")
    return {"capped_iters": int(capped.iters[0]),
            "iters": int(resumed.iters[0]), "passes": resumed.passes_over_A}


def sparse_stream(torch, repro_torch, ops, ref, dev, rate=None) -> tuple:
    """Phase 9 (see the module docstring): returns its numbers, the CSR
    kernels' rows and their launches on the main path."""
    import tempfile
    from repro_torch.core import staging
    t_phase = time.perf_counter()
    out: dict = {}
    if rate is None:
        rate = h2d_rates(torch, staging, dev)["pinned"]
    out["pinned_rate"] = rate
    sp = repro_torch.SyntheticSparseMatrix(SP_N, SP_N, SP_ROW, seed=0)
    print(f"9.1 the paper's per-node share: {sp.m}x{sp.n}, {sp.nnz} "
          f"nonzeros (density {sp.density:.2e}, {sp.dense_bytes / 1e15:.1f}"
          f" PB dense-equivalent; 32 of these are the paper's 128 PB), "
          f"{-(-sp.m // SP_BLOCK)} row blocks of {SP_BLOCK}; pinned H2D "
          f"{rate / 1e9:.2f} GB/s")
    t0 = time.perf_counter()
    rows = csr_kernel_rows(torch, ops, ref, sp, dev)
    print(f"  the CSR kernels' checks: {time.perf_counter() - t0:.1f} s")
    launches = {}
    for sd, profile in (("float32", False), ("bfloat16", True)):
        row = paper_share(torch, repro_torch, ops, sp, sd, rate, profile)
        out[sd] = row
        for key in CSR_REPLACES:
            label = key if sd == "float32" else f"{key}[bf16]"
            launches[label] = row["launches"].get(f"{key}/{sd}", 0)
    sp.close()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmpdir:
        out["spectrum"] = known_spectrum(torch, repro_torch, ops, dev,
                                         tmpdir)
        torch.cuda.empty_cache()
        out["dense_resume"] = dense_resume(torch, repro_torch, dev, tmpdir)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 9: {out['seconds']:.1f} s")
    return out, rows, launches


# ---------------------------------------------------------------------------
# phase 10: the paper's N-GPU layout (svd(A, k, mesh=...))
# ---------------------------------------------------------------------------

SH_SEED = SEED + 20                    # the phase's block matrix (M x N)
SH_RANKS = 4                           # gloo ranks sharing the card (10.2)
SH_DEFL = (M, N_GRAM)                  # 10.1's deflation solves
SH_DEFL_K = {"gramfree": K_GRAMFREE, "gram": K_GRAM}
SH_SMALL, SH_SMALL_K = (65536, 8192), 4   # 10.2's deflation solves
SH_WIDE, SH_WIDE_K = (4096, 65536), 16    # 10.2's wide input
SH_DEMOTE = (16384, 1024)              # 10.2's planted device OOM
SH_KILL_AT = 8                         # 10.2's resume: killed after it 8
SH_TIMEOUT = 420                       # seconds for the four ranks
SH_CHUNK = 1 << 30                     # bytes of fp32 rows a noise chunk
TOL_ORTH = 5e-3                        # |U^T U - I|, tests/test_distributed.py


def separable_matrix(torch, m, n, seed, dev, lo=0, hi=None):
    """Rows ``[lo, hi)`` of ``U diag(s) V^T + NOISE * G`` (s as
    ``spectral_matrix``): ``U`` and ``V`` from QR of seeded draws, made
    whole by every caller; ``G`` and the product one 1 GiB chunk of rows
    at a time, each chunk's noise from its own generator seeded by
    (seed, chunk) and each product over the whole chunk.  So any split of
    the rows over ranks builds bitwise the same matrix.  Returns (rows,
    s)."""
    hi = m if hi is None else hi
    g = torch.Generator(device=dev).manual_seed(seed)
    s = (100.0 * 0.9 ** torch.arange(N_SPECTRUM, dtype=torch.float64)
         ).to(torch.float32).to(dev)
    U = torch.linalg.qr(torch.randn(m, N_SPECTRUM, generator=g,
                                    device=dev)).Q
    V = torch.linalg.qr(torch.randn(n, N_SPECTRUM, generator=g,
                                    device=dev)).Q
    A = torch.empty((hi - lo, n), dtype=torch.float32, device=dev)
    step = max(1, SH_CHUNK // (4 * n))
    for c in range(lo // step, (hi - 1) // step + 1):
        r0, r1 = c * step, min((c + 1) * step, m)
        gc = torch.Generator(device=dev).manual_seed((seed << 32) + c)
        blk = (U[r0:r1] * s) @ V.mT
        blk.add_(torch.randn((r1 - r0, n), generator=gc, device=dev),
                 alpha=NOISE)
        a, b = max(r0, lo), min(r1, hi)
        A[a - lo:b - lo] = blk[a - r0:b - r0]
        del blk
    return A, s


def row_checksums(torch, A, parts: int) -> list:
    """The float64 sum and sum of squares of each of ``parts`` row
    slices, each summed a 1 GiB chunk of rows at a time in row order (no
    float64 copy of a whole slice): equal slices give equal bits."""
    m, step = A.shape[0] // parts, max(1, SH_CHUNK // (4 * A.shape[1]))
    out = []
    for i in range(parts):
        total = [0.0, 0.0]
        for r in range(i * m, (i + 1) * m, step):
            blk = A[r:min(r + step, (i + 1) * m)].double()
            total[0] += float(blk.sum())
            total[1] += float(blk.square().sum())
            del blk
        out.append(total)
    return out


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def collective_summary(coll) -> dict:
    """The collectives since the last reset, counted by (op, shape)."""
    out: dict = {}
    for c in coll.record:
        key = f"{c['op']}{list(c['shape'])}/{c['dtype']}"
        out[key] = out.get(key, 0) + 1
    return out


def deflation_collectives(method, faithful, n, k, iters, shards) -> dict:
    """What the reference's schedule issues (``core/dist_svd.py``): the
    fused chain one (n + k,) all-reduce a power step, the faithful three;
    the Gram path a reduce-scatter (fused, one axis) or all-reduce of B
    a rank and, fused, one all-gather of B_loc v (n / shards a rank) a
    step; a scalar all-reduce a rank for sigma."""
    steps, f32 = int(sum(iters)), "float32"
    want = {f"all_reduce[]/{f32}": len(iters)}
    if method == "gramfree" and not faithful:
        want[f"all_reduce[{n + k}]/{f32}"] = steps
    elif method == "gramfree":
        want[f"all_reduce[{n}]/{f32}"] = 2 * steps
        want[f"all_reduce[{k}]/{f32}"] = steps
    elif faithful:
        want[f"all_reduce[{n}, {n}]/{f32}"] = len(iters)
    else:
        want[f"reduce_scatter[{n}, {n}]/{f32}"] = len(iters)
        want[f"all_gather[{n // shards}]/{f32}"] = steps
    return want


def sharded_deflation(torch, repro_torch, ops, coll, mesh, X, k, method,
                      faithful, s, label, n_blocks=None) -> dict:
    """One deflation solve on ``mesh``, held to the prescribed spectrum,
    to the reference's collectives and passes, and (one rank) to the
    launches its schedule implies."""
    from repro_torch.core.config import SVDConfig
    nb = SVDConfig().n_blocks if n_blocks is None else n_blocks
    ops.reset_launches()
    coll.reset_record()
    res = repro_torch.svd(X, k, mesh=mesh, method=method, faithful=faithful,
                          n_blocks=nb)
    it = [int(i) for i in res.iters]
    steps = sum(it)
    got = collective_summary(coll)
    counts = {n_: c for n_, c in ops.launches.items() if c}
    err = float((res.S.double().cpu() / s[:k].double().cpu() - 1)
                .abs().max())
    n = X.shape[1]
    per_step = (0 if method == "gram" else 3 if faithful else 1)
    print(f"{label}: iters {it} (sum {steps}), passes_over_A "
          f"{res.passes_over_A}, wall_time_s {res.wall_time_s:.3f}, "
          f"collectives {got} ({per_step} a power step), launches {counts}, "
          f"max sigma rel err {err:.2e} (limit {TOL_DEFLATION:.0e})")
    want = deflation_collectives(method, faithful, n, k, it,
                                 mesh.size(mesh.mesh_dim_names.index("data")))
    if got != want:
        fail(f"{label}: collectives {got}, the schedule implies {want}")
    passes = 3 * k if method == "gram" else (3 if faithful else 2) * steps + k
    if res.passes_over_A != passes or res.backend != "sharded" \
            or res.bytes_moved is not None:
        fail(f"{label}: passes {res.passes_over_A} (want {passes}), "
             f"backend {res.backend}")
    if not (res.converged and err <= TOL_DEFLATION):
        fail(f"{label}: not converged to the prescribed sigma")
    return {"iters": it, "passes": res.passes_over_A,
            "wall_s": res.wall_time_s, "collectives": got,
            "launches": counts, "sigma_err": err, "res": res}


def sharded_one_rank(torch, repro_torch, ops, ref, bm, dev,
                     time_rows: bool = False) -> tuple:
    """10.1: one rank on NCCL at the paper's per-node shard.  Returns its
    numbers, each kernel's launches on its path and (``time_rows``) the
    deflation kernels' rows at the shapes this path gives them: ``matvec``
    on the whole 262144 x 8192 shard (the faithful chain, u recovery) and
    on a row block of it (the fused chain, ``n_blocks`` = 4), and
    ``deflate_rmatvec`` on that block."""
    import torch.distributed as dist
    from repro_torch.core import collectives as coll
    from repro_torch.launch.mesh import axes_group
    t_phase = time.perf_counter()
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    out: dict = {"backend": backend}
    path_counts: dict = {}
    rows: dict = {}
    try:
        mesh = repro_torch.make_host_mesh(device=dev.type)
        group = axes_group(mesh, ("data",))
        # one-time costs, timed apart so that the solves below time the
        # steady state: NCCL sets its communicator up at the first
        # collective; DTensor's import and its first tensor; the first eigh
        # on the device
        setup = {}

        def first_dtensor():
            from torch.distributed.tensor import DTensor, Replicate, Shard
            return DTensor.from_local(torch.zeros((1, K), device=dev), mesh,
                                      [Shard(0), Replicate()],
                                      run_check=False)
        for what, fn in (
                ("first_collective", lambda: coll.all_reduce(
                    torch.zeros(1, device=dev), group)),
                ("dtensor_import", lambda: __import__(
                    "torch.distributed.tensor")),
                ("first_dtensor", first_dtensor),
                ("first_eigh", lambda: torch.linalg.eigh(
                    torch.eye(K, device=dev)))):
            t0 = time.perf_counter()
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            setup[what] = time.perf_counter() - t0
        out["setup_s"] = setup
        print(f"10.1 {backend} at world size 1, one-time costs: " + ", ".join(
            f"{what} {t:.3f} s" for what, t in setup.items()))
        A, s = separable_matrix(torch, M, N, SH_SEED, dev)
        out["checksums"] = row_checksums(torch, A, SH_RANKS)
        bf16_kw = {"sweep_dtype": "bfloat16", "eps": 1e-4}
        for sd, kw, rtol, route in (("float32", {}, 1e-4, "tf32x3"),
                                    ("bfloat16", bf16_kw, 1e-2, "wgmma")):
            label = f"10.1 svd(A, {K}, mesh) {M}x{N} {sd} sweeps, 1 rank"
            ops.reset_launches()
            coll.reset_record()
            res = repro_torch.svd(A, K, mesh=mesh, **kw)
            counts = {n_: c for n_, c in ops.launches.items() if c}
            routes = {n_: c for n_, c in ops.route_launches.items() if c}
            got = collective_summary(coll)
            step_bytes = coll.record[0]["bytes"]
            it = int(res.iters[0])
            dense = repro_torch.svd(A, K, device=dev, **kw)
            err = float((res.S.double() / s[:K].double() - 1).abs().max())
            vs_dense = float((res.S.double() / dense.S.double() - 1)
                             .abs().max())
            print(f"{label}: iters {it} (dense {int(dense.iters[0])}), "
                  f"passes_over_A {res.passes_over_A}, bytes_per_pass "
                  f"{res.bytes_per_pass}, wall_time_s {res.wall_time_s:.3f} "
                  f"(dense {dense.wall_time_s:.3f}), collectives {got} "
                  f"({step_bytes} bytes a step), "
                  f"launches {counts} (by route {routes}), max sigma rel err "
                  f"{err:.2e} against the spectrum, {vs_dense:.2e} against "
                  f"the dense solve (limit {rtol:.0e})")
            want = {"block_gram_chain": it, "block_matvec": it + 1,
                    "block_rmatvec": it}
            want_routes = {f"block_matvec/{route}": it,
                           f"block_rmatvec/{route}": it}
            last = f"block_matvec/{bm.route(A, K)}"
            want_routes[last] = want_routes.get(last, 0) + 1
            if counts != want or routes != want_routes:
                fail(f"{label}: launches {counts} by route {routes}, the "
                     f"pass accounting implies {want} by route "
                     f"{want_routes}")
            if got != {f"all_reduce[{N}, {K}]/float32": it,
                       f"all_reduce[{K}, {K}]/float32": 1}:
                fail(f"{label}: collectives {got}, want one ({N}, {K}) "
                     f"all-reduce a step and the extraction's ({K}, {K})")
            if res.passes_over_A != 2 * it + 1 or res.backend != "sharded" \
                    or res.bytes_per_pass != M * N * (4 if sd == "float32"
                                                      else 2):
                fail(f"{label}: passes {res.passes_over_A} for {it} iters, "
                     f"backend {res.backend}")
            if not (res.converged and err <= rtol and vs_dense <= rtol):
                fail(f"{label}: sigma not within {rtol} of the spectrum and "
                     f"the dense solve")
            out[sd] = {"iters": it, "dense_iters": int(dense.iters[0]),
                       "wall_s": res.wall_time_s,
                       "dense_wall_s": dense.wall_time_s,
                       "passes": res.passes_over_A,
                       "bytes_per_pass": res.bytes_per_pass,
                       "collectives": got, "step_bytes": step_bytes,
                       "sigma_err": err,
                       "vs_dense": vs_dense}
            for n_, c in routes.items():
                key = f"{n_}[sharded]"
                path_counts[key] = path_counts.get(key, 0) + c
            path_counts[f"block_gram_chain/{route}[sharded]"] = \
                counts["block_gram_chain"]
            if sd == "float32":
                out["S"] = res.S.cpu().tolist()
                # the first sharded solve of a process pays one-time costs
                # beyond those timed above; the second is the steady state
                again = repro_torch.svd(A, K, mesh=mesh, **kw)
                out[sd]["second_wall_s"] = again.wall_time_s
                print(f"10.1 the same solve again: wall_time_s "
                      f"{again.wall_time_s:.3f} (dense "
                      f"{dense.wall_time_s:.3f}, "
                      f"{100 * (again.wall_time_s / dense.wall_time_s - 1):+.1f}"
                      f" %)")
                if not torch.equal(again.S, res.S):
                    fail("10.1: a rerun of the sharded solve differs")
                del again
                # the row-sharded U gathered by DTensor itself (on NCCL;
                # on a gloo mesh of CUDA tensors full_tensor() crashes,
                # ROADMAP.md queue 3, so 10.2 gathers through collectives)
                U = res.U.full_tensor()
                out["orth_err"] = float((U.mT @ U - torch.eye(
                    K, device=dev)).abs().max())
                print(f"10.1 U.full_tensor() {tuple(U.shape)}: |U^T U - I| "
                      f"{out['orth_err']:.2e} (limit {TOL_ORTH:.0e})")
                if out["orth_err"] > TOL_ORTH:
                    fail("10.1: U is not orthonormal")
                del U
            del res, dense
        # the all-reduce: events around the collective alone, and where a
        # profiled solve's device time goes
        x = torch.randn((N, K), device=dev)
        out["all_reduce_ms"] = time_ms(torch, lambda: coll.all_reduce(
            x, group), 20) if dev.type == "cuda" else None
        coll.reset_record()
        if dev.type == "cuda":
            _, wall, busy, n_act, names = profile_window(
                torch, lambda: repro_torch.svd(A, K, mesh=mesh))
            nccl = {n_: t for n_, t in names.items() if "nccl" in n_.lower()}
            out["profile"] = {"wall_s": wall, "busy_s": busy,
                              "idle": 1 - busy / wall,
                              "nccl_s": sum(nccl.values()),
                              "nccl_kernels": sorted(nccl)}
            print(f"10.1 profile of the fp32 sharded solve: {wall:.3f} s, "
                  f"device busy {busy:.3f} s (idle "
                  f"{100 * (1 - busy / wall):.1f} %), {n_act} activities; "
                  f"NCCL kernels {sum(nccl.values()) * 1e3:.3f} ms "
                  f"({sorted(nccl) or 'none: one rank sums nothing'}); "
                  f"one ({N}, {K}) all-reduce timed alone "
                  f"{out['all_reduce_ms']:.4f} ms")
        del A, x
        torch.cuda.empty_cache() if dev.type == "cuda" else None
        Ad, sdf = separable_matrix(torch, *SH_DEFL, SH_SEED + 1, dev)
        for method in ("gramfree", "gram"):
            for faithful in (True, False):
                k = SH_DEFL_K[method]
                row = sharded_deflation(
                    torch, repro_torch, ops, coll, mesh, Ad, k, method,
                    faithful, sdf, f"10.1 svd(A, {k}, mesh, method="
                    f"{method!r}, faithful={faithful}) {SH_DEFL[0]}x"
                    f"{SH_DEFL[1]}, 1 rank")
                nb = repro_torch.SVDConfig().n_blocks
                steps, counts = sum(row["iters"]), row["launches"]
                if method == "gram":
                    want = {"gram": k, "matvec": k}
                elif faithful:
                    want = {"matvec": 3 * steps + k}
                else:
                    want = {"matvec": nb * steps + k,
                            "deflate_rmatvec": nb * steps}
                if dev.type == "cuda" and counts != want:
                    fail(f"10.1 {method} faithful={faithful}: launches "
                         f"{counts}, the schedule implies {want}")
                tag = "faithful" if faithful else "fused"
                for n_, c in counts.items():
                    key = f"{n_}[sharded {method} {tag}]"
                    path_counts[key] = path_counts.get(key, 0) + c
                del row["res"]
                out[f"{method}/{tag}"] = row
        if time_rows:
            rows = sharded_kernel_rows(torch, ops, ref, Ad)
        del Ad
    finally:
        dist.destroy_process_group()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"10.1: {out['seconds']:.1f} s")
    return out, path_counts, rows


def sharded_kernel_rows(torch, ops, ref, Ad) -> dict:
    """The deflation kernels on the card against their plain versions at
    the sharded path's shapes, timed (phase 4's ``time_kernel``)."""
    from repro_torch.core.config import SVDConfig
    g = torch.Generator(device=Ad.device).manual_seed(SH_SEED + 5)
    m, n = Ad.shape
    blk = Ad[:m // SVDConfig().n_blocks]
    k = SH_DEFL_K["gramfree"]
    v = torch.randn(n, generator=g, device=Ad.device)
    Xv = torch.randn(blk.shape[0], generator=g, device=Ad.device)
    Ud = torch.randn((blk.shape[0], k), generator=g, device=Ad.device)
    c = torch.randn(k, generator=g, device=Ad.device)
    rows = {}
    for label, X in (("matvec/whole", Ad), ("matvec/block", blk)):
        rows[label] = time_kernel(
            torch, "matvec", lambda X=X: ops.matvec(X, v),
            lambda X=X: ref.matvec_ref(X, v), lambda X=X: torch.mv(X, v), 10,
            TOL["float32"], deflation_bound("matvec", *X.shape))
    rows["deflate_rmatvec/block"] = time_kernel(
        torch, "deflate_rmatvec", lambda: ops.deflate_rmatvec(blk, Ud, Xv, c),
        lambda: ref.deflate_rmatvec_ref(blk, Ud, Xv, c),
        lambda: (torch.mv(blk.mT, Xv - Ud @ c), Ud.mT @ Xv), 10,
        TOL["float32"], deflation_bound("deflate_rmatvec", *blk.shape, k))
    return rows


def sharded_rank(outdir: str, device_type: str) -> int:
    """10.2, one of ``SH_RANKS`` gloo ranks started by ``torchrun`` (this
    script with ``--sharded-rank DIR DEVICE``): its rows of the phase's
    matrix, the solves, and its numbers into ``DIR/rank<r>.json`` /
    ``.npz`` for the parent to compare."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    import repro_torch
    from repro_torch.core import collectives as coll
    from repro_torch.core.errors import KilledFault
    from repro_torch.core.faults import FaultPlan, FaultSpec, inject_faults
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import axes_group, mesh_device
    dist.init_process_group("gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = repro_torch.make_host_mesh(device=device_type)
    group, dev = axes_group(mesh, ("data",)), mesh_device(mesh)
    saved, out = {}, {"rank": rank, "device": str(dev)}

    def rows(m, n, seed):
        lo, hi = rank * m // world, (rank + 1) * m // world
        X, s = separable_matrix(torch, m, n, seed, dev, lo, hi)
        return DTensor.from_local(X, mesh, [Shard(0), Replicate()],
                                  run_check=False, shape=torch.Size((m, n)),
                                  stride=(n, 1)), s

    t0 = time.perf_counter()
    A, s = rows(M, N, SH_SEED)
    out["checksums"] = row_checksums(torch, A.to_local(), 1)[0]
    out["build_s"] = time.perf_counter() - t0

    def block(label, X, k, **kw):
        ops.reset_launches()
        coll.reset_record()
        res = repro_torch.svd(X, k, mesh=mesh, **kw)
        out[label] = {"iters": int(res.iters[0]),
                      "passes": res.passes_over_A,
                      "wall_s": res.wall_time_s, "backend": res.backend,
                      "collectives": collective_summary(coll),
                      "launches": {n_: c for n_, c in ops.launches.items()
                                   if c}}
        saved[f"{label}/S"] = res.S.cpu().numpy()
        return res

    res = block("block", A, K)
    # U is the row-sharded DTensor; gathered through the collectives
    # module, which gloo runs on CUDA tensors
    U = coll.all_gather(res.U.to_local(), group)
    out["block"]["orth_err"] = float((U.mT @ U - torch.eye(
        K, device=dev)).abs().max())
    saved["block/V"] = res.V.cpu().numpy()
    saved["block/U"] = res.U.to_local().cpu().numpy()
    x = torch.randn((N, K), device=dev)
    t0 = time.perf_counter()
    for _ in range(10):
        coll.all_reduce(x, group)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out["all_reduce_ms"] = (time.perf_counter() - t0) * 100
    again = block("block_rerun", A, K)
    out["rerun_bitwise"] = all(torch.equal(a.to_local() if hasattr(
        a, "to_local") else a, b.to_local() if hasattr(b, "to_local")
        else b) for a, b in zip(res[:3], again[:3]))
    del again
    # a resume after a kill at iteration SH_KILL_AT: the first rank writes
    # each step, every rank resumes from it; bitwise the uncut solve
    ck = os.path.join(outdir, "ck")
    try:
        with inject_faults(FaultPlan(FaultSpec("kill", at=SH_KILL_AT - 1))):
            repro_torch.svd(A, K, mesh=mesh, checkpoint_dir=ck)
        out["killed"] = False
    except KilledFault:
        out["killed"] = True
    from repro_torch.checkpoint import CheckpointManager
    out["resumed_from"] = CheckpointManager(ck).latest_step()
    resumed = block("resumed", A, K, checkpoint_dir=ck)
    out["resume_bitwise"] = all(torch.equal(
        a.to_local() if hasattr(a, "to_local") else a,
        b.to_local() if hasattr(b, "to_local") else b)
        for a, b in zip(res[:3], resumed[:3])) and \
        resumed.passes_over_A == res.passes_over_A
    # the transpose of the main matrix, A.mT: a wide DTensor whose
    # transposed-in rows are each rank's own (no copy)
    wide = block("transpose", A.mT, K)
    out["transpose"]["vs_block"] = float((wide.S.double() / res.S.double()
                                          - 1).abs().max())
    out["transpose"]["long_side"] = type(wide.V).__name__
    del res, resumed, wide, A, U
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # a wide input given whole (every rank copies its column slice)
    W, sw = separable_matrix(torch, *SH_WIDE, SH_SEED + 2, dev)
    res = block("wide", W, SH_WIDE_K)
    out["wide"]["sigma_err"] = float((res.S.double() / sw[:SH_WIDE_K]
                                      .double() - 1).abs().max())
    out["wide"]["long_side"] = type(res.V).__name__
    del W, res
    # the deflation engines on the small matrix, faithful and fused
    A2, s2 = rows(*SH_SMALL, SH_SEED + 3)
    for method in ("gramfree", "gram"):
        for faithful in (True, False):
            row = sharded_deflation(
                torch, repro_torch, ops, coll, mesh, A2, SH_SMALL_K, method,
                faithful, s2, f"10.2 rank {rank} svd(A, {SH_SMALL_K}, mesh, "
                f"method={method!r}, faithful={faithful}) {SH_SMALL[0]}x"
                f"{SH_SMALL[1]}")
            res = row.pop("res")
            saved[f"{method}/{faithful}/S"] = res.S.cpu().numpy()
            saved[f"{method}/{faithful}/V"] = res.V.cpu().numpy()
            out[f"{method}/{'faithful' if faithful else 'fused'}"] = row
    del A2, res
    # a planted device OOM: each rank's own rows move to its host, the
    # solve finishes on the host-blocked tier with the same collectives,
    # the iterations kept
    A3, _ = rows(*SH_DEMOTE, SH_SEED + 4)
    kw = dict(force_iters=True, max_iters=10)
    clean = repro_torch.svd(A3, 8, mesh=mesh, **kw)
    coll.reset_record()
    with inject_faults(FaultPlan(FaultSpec("device_oom", at=3))):
        demoted = repro_torch.svd(A3, 8, mesh=mesh, **kw)
    out["demote"] = {
        "backend": demoted.backend, "iters": int(demoted.iters[0]),
        "collectives": collective_summary(coll),
        "demotions": demoted.faults["counters"].get("device_oom.demote", 0),
        "vs_clean": float((demoted.S.double() / clean.S.double() - 1)
                          .abs().max())}
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **saved)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    # every rank is done with its pairs before any rank tears its own down
    dist.barrier()
    dist.destroy_process_group()
    return 0


def sharded_four_ranks(torch, dev, one_rank: dict) -> dict:
    """10.2: ``SH_RANKS`` gloo ranks sharing the card, started by
    ``torchrun`` under ``SH_TIMEOUT`` (a rank that fails or hangs ends
    them all, and the phase fails); their results held to each other
    (bitwise), to 10.1's solve of the same matrix and to the spectrum."""
    import signal
    import tempfile
    import numpy as np
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={SH_RANKS}", os.path.abspath(__file__),
               "--sharded-rank", tmp, dev.type]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True,
                                env=dict(os.environ, OMP_NUM_THREADS="2"))
        try:
            log = proc.communicate(timeout=SH_TIMEOUT)[0]
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            log = proc.communicate()[0]
            print(log[-6000:])
            fail(f"10.2: the {SH_RANKS} ranks did not finish in "
                 f"{SH_TIMEOUT} s")
        print("\n".join(l for l in log.splitlines()
                        if "10.2 rank 0" in l or "FAILED" in l))
        if proc.returncode != 0:
            print(log[-8000:])
            fail(f"10.2: torchrun exited {proc.returncode}")
        ranks = []
        for r in range(SH_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append((json.load(f), dict(np.load(os.path.join(
                    tmp, f"rank{r}.npz")))))
    first, arrays = ranks[0]
    for r, (_, arr) in enumerate(ranks[1:], 1):
        for key in arrays:
            if key.endswith("/U"):
                continue                      # each rank's own rows
            if not np.array_equal(arr[key], arrays[key]):
                fail(f"10.2: rank {r}'s {key} differs from rank 0's")
    for r, (row, _) in enumerate(ranks):
        for key in ("block", "block_rerun", "resumed", "transpose", "wide"):
            if row[key]["iters"] != first[key]["iters"]:
                fail(f"10.2: rank {r} took {row[key]['iters']} iterations "
                     f"of {key}, rank 0 {first[key]['iters']}")
        if row["checksums"] != one_rank["checksums"][r]:
            fail(f"10.2: rank {r}'s rows {row['checksums']} are not 10.1's "
                 f"{one_rank['checksums'][r]}: the split changed the matrix")
        if not (row["rerun_bitwise"] and row["killed"] and
                row["resumed_from"] == SH_KILL_AT and row["resume_bitwise"]):
            fail(f"10.2: rank {r}: rerun bitwise {row['rerun_bitwise']}, "
                 f"killed {row['killed']} at {row['resumed_from']}, resume "
                 f"bitwise {row['resume_bitwise']}")
        if row["block"]["orth_err"] > TOL_ORTH:
            fail(f"10.2: rank {r}: |U^T U - I| {row['block']['orth_err']}")
    S = arrays["block/S"]
    vs_one = float(np.abs(S.astype(np.float64) /
                          np.asarray(one_rank["S"]) - 1).max())
    b = first["block"]
    print(f"10.2 svd(A, {K}, mesh) {M}x{N} fp32 on {SH_RANKS} gloo ranks "
          f"sharing the card ({M // SH_RANKS} rows each): iters {b['iters']} "
          f"(1 rank: {one_rank['float32']['iters']}), wall_time_s "
          f"{b['wall_s']:.3f} (1 rank on NCCL: "
          f"{one_rank['float32']['wall_s']:.3f}), collectives a rank "
          f"{b['collectives']}, launches a rank {b['launches']}, sigma "
          f"within {vs_one:.2e} of 10.1 (limit 1e-4), |U^T U - I| "
          f"{b['orth_err']:.2e} (limit {TOL_ORTH:.0e}); S, V, iters bitwise "
          f"on every rank; rerun bitwise; killed after iteration "
          f"{first['resumed_from']} and resumed bitwise; one ({N}, {K}) "
          f"all-reduce on gloo {first['all_reduce_ms']:.3f} ms (host clock; "
          f"gloo stages through the host: not NCCL's cost)")
    if b["collectives"] != {f"all_reduce[{N}, {K}]/float32": b["iters"],
                            f"all_reduce[{K}, {K}]/float32": 1}:
        fail(f"10.2: collectives {b['collectives']}")
    if vs_one > 1e-4:
        fail(f"10.2: sigma {vs_one} from the one-rank solve")
    t = first["transpose"]
    print(f"10.2 the transpose, svd(A.mT, {K}, mesh) {N}x{M} (a wide "
          f"DTensor, each rank's rows its own): iters {t['iters']}, wall_time_s "
          f"{t['wall_s']:.3f}, long side a {t['long_side']}, sigma within "
          f"{t['vs_block']:.2e} of svd(A) (limit 1e-4)")
    if t["vs_block"] > 1e-4 or t["long_side"] != "DTensor":
        fail("10.2: the transpose")
    w = first["wide"]
    print(f"10.2 wide {SH_WIDE[0]}x{SH_WIDE[1]} svd(A, {SH_WIDE_K}, mesh) "
          f"given whole: iters {w['iters']}, long side a {w['long_side']}, "
          f"max sigma rel err {w['sigma_err']:.2e} (limit 1e-4)")
    if w["sigma_err"] > 1e-4 or w["long_side"] != "DTensor":
        fail("10.2: the wide input")
    d = first["demote"]
    print(f"10.2 planted device OOM at step 3 ({SH_DEMOTE[0]}x"
          f"{SH_DEMOTE[1]}): backend {d['backend']}, {d['demotions']} "
          f"demotion, iters {d['iters']}, sigma within {d['vs_clean']:.2e} "
          f"of the clean sharded solve (limit 1e-4), collectives "
          f"{d['collectives']}")
    n3 = SH_DEMOTE[1]
    if not (d["backend"] == "hostblocked" and d["demotions"] == 1 and
            d["iters"] == 10 and d["vs_clean"] <= 1e-4 and
            d["collectives"] == {f"all_reduce[{n3}, 8]/float32": 10,
                                 "all_reduce[8, 8]/float32": 1}):
        fail("10.2: the planted device OOM")
    out = {"ranks": SH_RANKS, "backend": "gloo", "block": b,
           "vs_one_rank": vs_one, "transpose": t, "wide": w, "demote": d,
           "all_reduce_ms_gloo": first["all_reduce_ms"],
           "build_s": first["build_s"],
           "deflation": {key: first[key] for key in first if "/" in key}}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"10.2: {out['seconds']:.1f} s")
    return out


def sharded(torch, repro_torch, ops, ref, bm, dev,
            time_rows: bool = False) -> tuple:
    """Phase 10 (see the module docstring): returns its numbers, each
    kernel's launches on the one-rank path and the deflation kernels'
    rows at its shapes (``time_rows``)."""
    t_phase = time.perf_counter()
    one, path_counts, rows = sharded_one_rank(torch, repro_torch, ops, ref,
                                              bm, dev, time_rows)
    four = sharded_four_ranks(torch, dev, one)
    summary = {"one_rank": one, "four_ranks": four,
               "seconds": time.perf_counter() - t_phase}
    print(f"phase 10: {summary['seconds']:.1f} s")
    return summary, path_counts, rows


def sharded_kernel_line(counts: dict, table: dict, dtable: dict,
                        rows: dict) -> list:
    """The kernels line's entries for the sharded path (one rank, 10.1):
    its launches by kernel and route, each beside the row measured at the
    same shape (the block sweeps' phase-2b rows at 262144 x 32768, k =
    32; ``gram``'s phase-5 row at 262144 x 8192; ``matvec`` and
    ``deflate_rmatvec`` from ``sharded_kernel_rows``)."""
    out = []
    for key, c in sorted(counts.items()):
        name, tag = key.split("[", 1)
        kernel = name.split("/")[0]
        if "/" in name:
            which = name.split("/")[1]
            row = table[(kernel, "float32" if which == "tf32x3"
                         else "bfloat16")]
            source = TF32_SOURCE if which == "tf32x3" else TC_SOURCE
        elif kernel == "gram":
            row, source = dtable["gram"], SOURCES["gram"]
        else:
            # the fused chain's sweeps run on row blocks (n_blocks = 4);
            # u recovery and the faithful chain on the whole shard
            shape = "block" if "gramfree fused" in tag else "whole"
            row, source = rows[f"{kernel}/{shape}"], SOURCES[kernel]
        out.append({"name": key, "route": "cuda", "source": source,
                    "replaces": REPLACES[kernel], "launches": c,
                    **{f: row[f] for f in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms")}})
    return out


def csr_kernel_line(rows: dict, launches: dict) -> list:
    """The CSR kernels' entries of the ``kernels`` line."""
    return [{"name": name, "route": "cuda", "source": CSR_SOURCE,
             "replaces": CSR_REPLACES[name.split("[")[0]],
             "launches": launches[name], "max_abs_err": row["max_abs_err"],
             "ms": row["ms"], "plain_ms": row["plain_ms"],
             "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
             "library_ms": row["library_ms"]}
            for name, row in rows.items()]


# ---------------------------------------------------------------------------
# phase 11: the SVD service (repro_torch.serving) on the card
# ---------------------------------------------------------------------------

SV_SEED = SEED + 30
SV_BUDGET = 48 << 30                   # bytes: one 32 GiB shard job at a time
SV_STREAM = 4                          # the shard job's stream_every
SV_DEADLINE = 900.0                    # s, the second shard job's deadline
SV_BURST = 256                         # small jobs a burst
SV_SMALL = (1024, 256)                 # m * n = the batcher's MAX_BATCH_ELEMS
SV_K_SMALL = 8                         # warmup_q=1: l = 16
SV_MAX_BATCH = 16
SV_NAN = 37                            # the burst's poisoned job
SV_HB = (65536, 8192)                  # the host-blocked and deflation jobs' A
SV_HB_BLOCKS = 4
SV_K_DEFL = 4
SV_RETIME = (65536, 8192, 16)          # deflate_rmatvec's re-time: m, n, k
SV_RETIME_RUNS = 7                     # alternating runs of it and the yardstick
SV_WAIT = 300.0                        # s, every wait on a job
TOL_COS = 1e-3                         # 1 - subspace cosine, tests/test_operator_contract.py
TOL_LANE = 1e-4                        # a lane's sigma rtol to its per-job
                                       # solve, fp32 and bf16 alike
                                       # (tests/test_torch_serving_batch.py)


def cosines_min(torch, X, Y) -> float:
    """The smallest cosine of the principal angles between span(X) and
    span(Y) (orthonormal columns)."""
    return float(torch.linalg.svdvals(X.double().mT @ Y.double()).min())


def retime_deflate_rmatvec(torch, ops, ref, Ad, g) -> dict:
    """``deflate_rmatvec`` at ``SV_RETIME`` against its two-call
    yardstick, ``SV_RETIME_RUNS`` runs of each in turns (kernel,
    yardstick, yardstick, kernel, ...; 20 launches a run, CUDA events):
    the spread of each and whether the kernel's trail is beyond it."""
    m, n, k = SV_RETIME
    X = Ad[:m, :n]
    Ud = torch.randn((m, k), generator=g, device=Ad.device)
    Xv = torch.randn(m, generator=g, device=Ad.device)
    c = torch.randn(k, generator=g, device=Ad.device)
    kern = lambda: ops.deflate_rmatvec(X, Ud, Xv, c)
    lib = lambda: (torch.mv(X.mT, Xv - Ud @ c), Ud.mT @ Xv)
    check(torch, "deflate_rmatvec (re-time)", kern()[0],
          ref.deflate_rmatvec_ref(X, Ud, Xv, c)[0], TOL["float32"])
    runs = {"kernel": [], "two calls": []}
    for i in range(SV_RETIME_RUNS):
        order = ("kernel", "two calls") if i % 2 == 0 else \
            ("two calls", "kernel")
        for label in order:
            runs[label].append(time_ms(torch, kern if label == "kernel"
                                       else lib, 20))
    bnd, by = deflation_bound("deflate_rmatvec", m, n, k)
    kmin, kmax = min(runs["kernel"]), max(runs["kernel"])
    lmin, lmax = min(runs["two calls"]), max(runs["two calls"])
    beyond = kmin > lmax                  # every kernel run slower
    verdict = ("slower in every run: a trail beyond the spread" if beyond
               else "faster in every run" if kmax < lmin
               else "within the spread of the two")
    print(f"  deflate_rmatvec re-time at {m}x{n}, k={k} ({SV_RETIME_RUNS} "
          f"runs each, in turns): kernel {kmin:.4f}-{kmax:.4f} ms (median "
          f"{sorted(runs['kernel'])[SV_RETIME_RUNS // 2]:.4f}), two calls "
          f"{lmin:.4f}-{lmax:.4f} ms (median "
          f"{sorted(runs['two calls'])[SV_RETIME_RUNS // 2]:.4f}), bound "
          f"{bnd:.4f} ms ({by}); the kernel is {verdict}")
    return {"shape": [m, n, k], "kernel_ms": runs["kernel"],
            "two_calls_ms": runs["two calls"], "bound_ms": bnd,
            "trail_beyond_spread": beyond}


def burst_inputs(torch, dev):
    """``SV_BURST`` small matrices (``SV_SMALL``), stacked on the card:
    ``U diag(s) V^T + NOISE * G`` with s_i = 10 * 0.7**i, i < 32; job
    ``SV_NAN`` holds a NaN."""
    g = torch.Generator(device=dev).manual_seed(SV_SEED + 1)
    m, n = SV_SMALL
    s = (10.0 * 0.7 ** torch.arange(32, dtype=torch.float64)).to(
        torch.float32).to(dev)
    U = torch.linalg.qr(torch.randn((SV_BURST, m, 32), generator=g,
                                    device=dev)).Q
    V = torch.linalg.qr(torch.randn((SV_BURST, n, 32), generator=g,
                                    device=dev)).Q
    X = (U * s) @ V.mT
    X.add_(torch.randn(X.shape, generator=g, device=dev), alpha=NOISE)
    X[SV_NAN, 3, 5] = float("nan")
    return X


def serve_burst(torch, repro_torch, ops, bm, svc, X, sd) -> tuple:
    """One burst through the service (batched) and the same jobs one by
    one through ``repro_torch.svd``: every lane held to its per-job solve
    (sigma, subspace), the NaN lane failing alone, the dispatches, the
    per-job solves' launches to their pass accounting by route, the
    rates.  Returns (summary, launches by path key)."""
    from repro_torch.core.config import SVDConfig
    from repro_torch.core.errors import (FaultExhaustedError,
                                         NumericalHealthError)
    from repro_torch.serving import JobSpec, JobStatus
    from repro_torch.serving.batcher import solve_batch
    eps, rtol = 1e-8 if sd == "float32" else 1e-4, TOL_LANE
    cfgs = [SVDConfig(warmup_q=1, eps=eps, seed=i, sweep_dtype=sd)
            for i in range(SV_BURST)]
    label = f"burst {sd}"

    def tf32_off():
        if torch.backends.cuda.matmul.allow_tf32 or \
                torch.get_float32_matmul_precision() != "highest":
            fail(f"{label}: TF32 is on for fp32 matmuls (allow_tf32 "
                 f"{torch.backends.cuda.matmul.allow_tf32}, precision "
                 f"{torch.get_float32_matmul_precision()!r})")

    tf32_off()
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hs = [svc.submit(X[i], SV_K_SMALL, config=cfgs[i], tag=f"{label} {i}")
          for i in range(SV_BURST)]
    for h in hs:
        h.wait(SV_WAIT)
    t_batched = time.perf_counter() - t0
    tf32_off()
    ran = {n_: c for n_, c in ops.launches.items() if c}
    if ran:
        fail(f"{label}: the batched dispatches launched {ran} (they run "
             f"torch.bmm, no kernel of the port)")
    recs = {r.job_id: r for r in svc.meter.records}
    sizes = [recs[h.job_id].batch_size for h in hs]
    if not all(recs[h.job_id].batched for h in hs) or \
            sizes != [SV_MAX_BATCH] * SV_BURST:
        fail(f"{label}: batch sizes {sorted(set(sizes))}, want "
             f"{SV_BURST // SV_MAX_BATCH} dispatches of {SV_MAX_BATCH}")
    # the same jobs one by one, timed; then each lane against its job
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    per_job, nan_delta = [], {}
    for i in range(SV_BURST):
        if i == SV_NAN:
            before = dict(ops.route_launches), dict(ops.launches)
            try:
                repro_torch.svd(X[i], SV_K_SMALL, config=cfgs[i])
            except FaultExhaustedError:
                pass
            else:
                fail(f"{label}: the per-job solve of the NaN job finished")
            nan_delta = ({n_: c - before[0][n_] for n_, c in
                          ops.route_launches.items()},
                         {n_: c - before[1][n_] for n_, c in
                          ops.launches.items()})
            per_job.append(None)
            continue
        r = repro_torch.svd(X[i], SV_K_SMALL, config=cfgs[i])
        per_job.append((r.S.cpu(), r.V.cpu(), int(r.iters[0])))
    torch.cuda.synchronize()
    t_seq = time.perf_counter() - t0
    its = [p[2] for p in per_job if p is not None]
    chain = bm.route(X[0].to(getattr(torch, sd)), 2 * SV_K_SMALL)
    fp32 = bm.route(X[0], 2 * SV_K_SMALL)
    if (chain, fp32) != ({"float32": "tf32x3", "bfloat16": "wgmma"}[sd],
                         "tf32x3"):
        fail(f"{label}: routes {chain} / {fp32}")
    want = {"block_gram_chain": sum(its) + len(its),
            "block_matvec": sum(its) + 2 * len(its),
            "block_rmatvec": sum(its) + 2 * len(its)}
    want_routes = {f"block_matvec/{chain}": sum(its) + len(its),
                   f"block_rmatvec/{chain}": sum(its) + 2 * len(its)}
    want_routes[f"block_matvec/{fp32}"] = \
        want_routes.get(f"block_matvec/{fp32}", 0) + len(its)
    got = {n_: c - nan_delta[1].get(n_, 0) for n_, c in ops.launches.items()}
    got_routes = {n_: c - nan_delta[0].get(n_, 0)
                  for n_, c in ops.route_launches.items()}
    got = {n_: c for n_, c in got.items() if c}
    got_routes = {n_: c for n_, c in got_routes.items() if c}
    if got != want or got_routes != want_routes:
        fail(f"{label}: the per-job solves launched {got} by route "
             f"{got_routes}; their pass accounting implies {want} by route "
             f"{want_routes}")
    worst_s, worst_cos, lane_its = 0.0, 1.0, []
    for i, (h, p) in enumerate(zip(hs, per_job)):
        if i == SV_NAN:
            if h.status is not JobStatus.FAILED or not isinstance(
                    h.error, NumericalHealthError) or \
                    h.error_kind != "internal":
                fail(f"{label}: the NaN lane ended {h.status} "
                     f"({type(h.error).__name__}, {h.error_kind})")
            continue
        if h.status is not JobStatus.DONE:
            fail(f"{label}: lane {i} ended {h.status} ({h.error})")
        res = h.result(1.0)
        S, V = res.S.cpu(), res.V.cpu()
        e = float((S.double() / p[0].double() - 1).abs().max())
        cos = cosines_min(torch, V, p[1])
        worst_s, worst_cos = max(worst_s, e), min(worst_cos, cos)
        lane_its.append(int(res.iters[0]))
        if not (e <= rtol and cos > 1 - TOL_COS and res.backend == "dense"
                and res.passes_over_A == 3 + 2 * int(res.iters[0]) + 1):
            fail(f"{label}: lane {i} sigma rel err {e} (limit {rtol}), "
                 f"cosine {cos}, passes {res.passes_over_A}")
    batchmates = [h.status.value for i, h in enumerate(hs)
                  if i // SV_MAX_BATCH == SV_NAN // SV_MAX_BATCH]
    # where a dispatch's time goes, beside one job's own solve
    specs = [JobSpec(input=X[i], k=SV_K_SMALL, config=cfgs[i])
             for i in range(SV_MAX_BATCH)]
    prof = {}
    for what, fn in (("one batched dispatch of 16 lanes",
                      lambda: solve_batch(specs, device=X.device)),
                     ("one job's own solve",
                      lambda: repro_torch.svd(X[0], SV_K_SMALL,
                                              config=cfgs[0]))):
        _, wall, busy, n_act, names = profile_window(torch, fn)
        top = sorted(names.items(), key=lambda x: -x[1])[:5]
        prof[what] = {"wall_s": wall, "busy_s": busy, "activities": n_act}
        print(f"  {label}, profile of {what}: {wall:.4f} s, device busy "
              f"{busy:.4f} s ({100 * busy / wall:.1f} %), {n_act} device "
              f"activities; by time: " + ", ".join(
                  f"{n_[:40]} {1e3 * t:.2f} ms" for n_, t in top))
    out = {"jobs": SV_BURST, "dispatches": SV_BURST // SV_MAX_BATCH,
           "batched_s": t_batched, "sequential_s": t_seq,
           "batched_jobs_per_s": SV_BURST / t_batched,
           "sequential_jobs_per_s": SV_BURST / t_seq,
           "sigma_rel_err_max": worst_s, "cosine_min": worst_cos,
           "lane_iters": [min(lane_its), max(lane_its)],
           "per_job_iters": [min(its), max(its)],
           "nan_lane_batch": batchmates, "profiles": prof}
    print(f"{label}: {SV_BURST} jobs {SV_SMALL[0]}x{SV_SMALL[1]}, k="
          f"{SV_K_SMALL}, warmup_q=1, eps={eps:g}: batched in "
          f"{out['dispatches']} dispatches of {SV_MAX_BATCH} in "
          f"{t_batched:.3f} s ({out['batched_jobs_per_s']:.1f} jobs/s), "
          f"one by one through repro_torch.svd in {t_seq:.3f} s "
          f"({out['sequential_jobs_per_s']:.1f} jobs/s; "
          f"{t_seq / t_batched:.2f}x); lanes' sigma within {worst_s:.2e} "
          f"(limit {rtol:.0e}) and cosines >= {worst_cos:.7f} of their "
          f"per-job solves; iterations: lanes {out['lane_iters']}, per job "
          f"{out['per_job_iters']}; the NaN lane {SV_NAN} failed alone "
          f"(NumericalHealthError), its batch {batchmates.count('done')} "
          f"done; per-job launches {got} by route {got_routes}")
    return out, {f"{n_}[service burst {sd}, one by one]": c
                 for n_, c in got_routes.items()}


def serving(torch, repro_torch, ops, ref, bm, dev, table=None) -> tuple:
    """Phase 11 (see the module docstring): returns its numbers and its
    entries of the kernels line."""
    import contextlib
    import gc
    import threading

    import numpy as np
    from repro_torch.core import CountingHostMatrix, SVDConfig
    from repro_torch.core.errors import InputError
    from repro_torch.serving import JobStatus, SVDService
    from repro_torch.serving.batcher import MAX_BATCH_ELEMS
    t_phase = time.perf_counter()
    if SV_SMALL[0] * SV_SMALL[1] != MAX_BATCH_ELEMS:
        fail(f"burst jobs of {SV_SMALL} are not the batcher's "
             f"MAX_BATCH_ELEMS = {MAX_BATCH_ELEMS}")
    # -- the inputs, all on the card before the service starts -----------
    A, _ = spectral_matrix(torch, M, N, SEED, dev)     # phase 3's matrix
    Ad, s_d = spectral_matrix(torch, *SV_HB, SV_SEED, dev)
    H = Ad.cpu().numpy()                  # the host-blocked job's array
    Xb = burst_inputs(torch, dev)
    torch.cuda.synchronize()
    # -- the kernels at phase 11's shapes, against their plain versions ---
    g = torch.Generator(device=dev).manual_seed(SV_SEED + 2)
    rows = {}

    def sweeps(key, X, k, sd):
        Q = torch.linalg.qr(torch.randn((X.shape[1], k), generator=g,
                                        device=dev)).Q
        Y = torch.randn((X.shape[0], k), generator=g, device=dev)
        rows[key] = sweep_rows(torch, ops, ref, bm, X, Q, Y, sd)

    if table is not None and ("block_matvec", "float32") in table:
        rows["shard"] = {n_: table[(n_, "float32")] for n_ in
                         ("block_matvec", "block_rmatvec", "block_gram_chain")}
    else:
        sweeps("shard", A, K, "float32")
    sweeps("host block", Ad[:SV_HB[0] // SV_HB_BLOCKS], K, "float32")
    sweeps("burst float32", Xb[0], 2 * SV_K_SMALL, "float32")
    sweeps("burst bfloat16", Xb[0], 2 * SV_K_SMALL, "bfloat16")
    v = torch.randn(SV_HB[1], generator=g, device=dev)
    Xv = torch.randn(SV_HB[0], generator=g, device=dev)
    Ud = torch.randn((SV_HB[0], SV_K_DEFL), generator=g, device=dev)
    c = torch.randn(SV_K_DEFL, generator=g, device=dev)
    rows["deflation"] = {
        "matvec": time_kernel(
            torch, "matvec", lambda: ops.matvec(Ad, v),
            lambda: ref.matvec_ref(Ad, v), lambda: torch.mv(Ad, v), 10,
            TOL["float32"], deflation_bound("matvec", *SV_HB)),
        "deflate_rmatvec": time_kernel(
            torch, "deflate_rmatvec",
            lambda: ops.deflate_rmatvec(Ad, Ud, Xv, c),
            lambda: ref.deflate_rmatvec_ref(Ad, Ud, Xv, c),
            lambda: (torch.mv(Ad.mT, Xv - Ud @ c), Ud.mT @ Xv), 10,
            TOL["float32"],
            deflation_bound("deflate_rmatvec", *SV_HB, SV_K_DEFL)),
        "gram": time_kernel(
            torch, "gram", lambda: ops.gram(Ad), lambda: ref.gram_ref(Ad),
            lambda: torch.mm(Ad.mT, Ad), 3, gram_tol(SV_HB[0]),
            deflation_bound("gram", *SV_HB), offdiag=True)}
    retime = retime_deflate_rmatvec(torch, ops, ref, Ad, g)
    del v, Xv, Ud, c
    # the plain solve of the shard job's A (warm, then timed)
    repro_torch.svd(A, K)
    plain = repro_torch.svd(A, K)
    plain_S, plain_it, plain_wall = plain.S.cpu(), int(plain.iters[0]), \
        plain.wall_time_s
    del plain
    print(f"plain repro_torch.svd(A, {K}) of the shard: iters {plain_it}, "
          f"wall_time_s {plain_wall:.3f}")

    # -- the service --------------------------------------------------------
    clear_ws = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)

    def settled() -> int:
        """Device bytes allocated once every dropped tensor is freed:
        cuBLAS's per-thread workspaces cleared, and the blocks freed
        under ``record_stream`` (the host-blocked tier's copy buffers)
        returned, which the allocator does when it processes its events
        (``empty_cache`` does)."""
        gc.collect()
        torch.cuda.synchronize()
        if clear_ws is not None:
            clear_ws()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated()

    base = settled()

    def run_service() -> tuple:
        """The service and its jobs (every reference to them local, so
        that their device memory is free once it returns)."""
        hb = CountingHostMatrix(H, SV_HB_BLOCKS, device=dev)
        gate = threading.Event()

        def park(state):
            """The second shard job, after its first partial: wait until the
            client has cancelled it (its launches are then fixed: two
            steps, one extraction)."""
            if state.it == 1:
                gate.wait(SV_WAIT)

        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        svc = SVDService(max_workers=2, byte_budget=SV_BUDGET,
                         batch_window_s=0.25, max_batch=SV_MAX_BATCH, device=dev)
        summary = {}
        # the gate opens on the way out whatever happens, so a failed check
        # never leaves a worker parked while the service drains
        with svc, contextlib.ExitStack() as opened:
            opened.callback(gate.set)
            t0 = time.perf_counter()
            h1 = svc.submit(A, K, priority=1, stream_every=SV_STREAM,
                            tag="shard")
            hg = svc.submit(Ad, SV_K_DEFL, method="gramfree", priority=1,
                            tag="gramfree")
            hgr = svc.submit(Ad, SV_K_DEFL, method="gram", priority=1,
                             tag="gram")
            hh = svc.submit(hb, K, priority=1, tag="host-blocked")
            he = svc.submit(Xb[1], SV_SMALL[1] + 1, priority=1,
                            tag="input error")          # k > min(m, n)
            h2 = svc.submit(A, K, priority=0, deadline_s=SV_DEADLINE,
                            stream_every=1, config=SVDConfig(on_iteration=park),
                            tag="shard, second")
            partials = list(h1.stream(timeout=SV_WAIT))
            first = next(iter(h2.stream(timeout=SV_WAIT)))
            j1, j2 = svc._jobs[h1.job_id], svc._jobs[h2.job_id]
            if not (j2.started_at is not None and j1.finished_at is not None
                    and j2.started_at >= j1.finished_at):
                fail("the second shard job ran before the first ended: the "
                     "byte budget admitted two 32 GiB estimates")
            h2.cancel()
            gate.set()
            for h in (h1, h2, hg, hgr, hh, he):
                h.wait(SV_WAIT)
            t_group = time.perf_counter() - t0
            counts = {n_: c for n_, c in ops.launches.items() if c}
            routes = {n_: c for n_, c in ops.route_launches.items() if c}
            peak = torch.cuda.max_memory_allocated()
            ended = [(h.job_id, h.status.value, h.error)
                     for h in (h1, h2, hg, hgr, hh, he)]
            if [e[1] for e in ended] != ["done", "cancelled", "done", "done",
                                         "done", "failed"]:
                fail(f"phase 11 jobs ended {ended}")
            if not isinstance(he.error, InputError) or he.error_kind != "input":
                fail(f"the input-error job: {he.error!r} ({he.error_kind})")
            r1, rg, rgr, rh = (h.result(1.0) for h in (h1, hg, hgr, hh))
            # the shard job against the plain solve of the same A
            it1 = int(r1.iters[0])
            e1 = float((r1.S.cpu().double() / plain_S.double() - 1).abs().max())
            if it1 != plain_it or e1 > 1e-4 or not r1.converged:
                fail(f"the shard job: iters {it1} (plain {plain_it}), sigma rel "
                     f"err {e1} against the plain solve")
            if len(partials) != it1 // SV_STREAM or h1.partial_count != \
                    len(partials) or first.it != 1 or h2.partial_count != 1:
                fail(f"partials: shard {len(partials)} for {it1} iters, second "
                     f"{h2.partial_count} (first at it {first.it})")
            if partials[-1].U.shape != (M, K) or not np.isfinite(
                    partials[-1].S).all():
                fail(f"the shard job's last partial: U {partials[-1].U.shape}")
            # the host-blocked and deflation jobs against their spectrum
            ith, ph = int(rh.iters[0]), rh.passes_over_A
            nb = SV_HB_BLOCKS
            itg = [int(i) for i in rg.iters]
            for label, res, k, tol in (("host-blocked", rh, K, 1e-4),
                                       ("gramfree", rg, SV_K_DEFL, TOL_DEFLATION),
                                       ("gram", rgr, SV_K_DEFL, TOL_DEFLATION)):
                e = float((res.S.cpu().double() / s_d[:k].cpu().double() - 1)
                          .abs().max())
                if not (res.converged and e <= tol):
                    fail(f"the {label} job: sigma rel err {e} (limit {tol})")
            if rh.backend != "hostblocked" or ph != ith + 1 or \
                    hb.fetches != nb * ph:
                fail(f"the host-blocked job: backend {rh.backend}, passes {ph} "
                     f"for {ith} iters, fetches {hb.fetches}")
            # every launch of the window, job by job (each job's own tally,
            # ``Job.launches``) against that job's pass accounting (the
            # second shard job: two chains and one partial's extraction),
            # and the window's totals against their sum
            def sweeps_want(chains, matvecs, rmatvecs):
                return {"block_gram_chain": chains,
                        "block_matvec": matvecs,
                        "block_matvec/tf32x3": matvecs,
                        "block_rmatvec": rmatvecs,
                        "block_rmatvec/tf32x3": rmatvecs}

            jobs = {
                "shard": (j1, sweeps_want(it1, it1 + 1 + len(partials), it1)),
                "shard, second": (j2, sweeps_want(2, 2 + 1, 2)),
                "host-blocked": (svc._jobs[hh.job_id], sweeps_want(
                    nb * ith, nb * (ith + 1), nb * ith)),
                "gramfree": (svc._jobs[hg.job_id],
                             {"matvec": sum(itg) + SV_K_DEFL,
                              "deflate_rmatvec": sum(itg)}),
                "gram": (svc._jobs[hgr.job_id],
                         {"matvec": SV_K_DEFL, "gram": SV_K_DEFL,
                          "gram/tf32x3": SV_K_DEFL}),
                "input error": (svc._jobs[he.job_id], {})}
            per_job = {tag: dict(j.launches) for tag, (j, _) in jobs.items()}
            for tag, (_, w) in jobs.items():
                if per_job[tag] != w:
                    fail(f"the {tag} job launched {per_job[tag]}; its pass "
                         f"accounting (the shard job's {it1} iterations and "
                         f"{len(partials)} partials, the host-blocked job's "
                         f"{ith}, the gram-free job's {itg}) implies {w}")
            want, want_routes = {}, {}
            for _, w in jobs.values():
                for key, c in w.items():
                    into = want_routes if "/" in key else want
                    into[key] = into.get(key, 0) + c
            if counts != want or routes != want_routes:
                fail(f"phase 11 launches {counts} by route {routes}; the "
                     f"jobs' tallies sum to {want} by route {want_routes}")
            if peak >= 80e9:
                fail(f"peak device memory {peak} bytes")
            recs = {r.job_id: r for r in svc.meter.records}
            wait2 = recs[h2.job_id].queue_wait_s
            print(f"service: 6 jobs in {t_group:.3f} s on 2 workers, byte "
                  f"budget {SV_BUDGET / 2**30:.0f} GiB; the shard job "
                  f"(stream_every={SV_STREAM}): iters {it1} (plain {plain_it}), "
                  f"sigma within {e1:.2e} of the plain solve, wall_time_s "
                  f"{r1.wall_time_s:.3f} (plain {plain_wall:.3f}), "
                  f"{len(partials)} partials (last gap {partials[-1].gap}); the "
                  f"second shard job waited {wait2:.3f} s in the queue (started "
                  f"{j2.started_at - j1.finished_at:.3f} s after the first "
                  f"ended), cancelled after its first partial; peak device "
                  f"memory {peak / 2**30:.2f} GiB; the host-blocked job: iters "
                  f"{ith}, passes {ph}, fetches {hb.fetches}; gramfree iters "
                  f"{itg}; launches by job {per_job}")
            summary["group"] = {
                "seconds": t_group, "shard_iters": it1, "plain_iters": plain_it,
                "shard_wall_s": r1.wall_time_s, "plain_wall_s": plain_wall,
                "shard_run_wall_s": recs[h1.job_id].run_wall_s,
                "partials": len(partials), "second_queue_wait_s": wait2,
                "peak_device_bytes": peak, "hostblocked_iters": ith,
                "gramfree_iters": itg, "launches": per_job}
            del r1, rg, rgr, rh, partials, first

            # -- the bursts --------------------------------------------------
            # the kernels line's service entries: each job's measured
            # launches by route (the chain under its halves' route)
            line_counts = {}
            for tag, launched in per_job.items():
                for key, c in launched.items():
                    if "/" in key:
                        line_counts[f"{key}[service {tag}]"] = c
                    elif key == "block_gram_chain":
                        route = next(r for r in launched
                                     if r.startswith("block_matvec/"))
                        line_counts[f"block_gram_chain/{route.split('/')[1]}"
                                    f"[service {tag}]"] = c
                    elif key in ("matvec", "deflate_rmatvec"):
                        line_counts[f"{key}[service {tag}]"] = c
            for sd in ("float32", "bfloat16"):
                summary[f"burst {sd}"], extra = serve_burst(
                    torch, repro_torch, ops, bm, svc, Xb, sd)
                line_counts.update(extra)
            metrics = svc.metrics()
        # -- metering: the records' integers are the results' own -------------
        done = [j for j in svc._jobs.values() if j.status is JobStatus.DONE]
        recs = {r.job_id: r for r in svc.meter.records}
        for j in done:
            r, res = recs[j.job_id], j.result
            if (r.passes_over_A, r.bytes_per_pass, r.bytes_moved, r.backend) != (
                    int(res.passes_over_A), int(res.bytes_per_pass),
                    res.bytes_moved, res.backend) or \
                    r.stream_extracts != j.partial_count:
                fail(f"{j.job_id}: cost record {r} against its result")
        for j in (j1, j2, *(svc._jobs[h.job_id] for h in (hg, hgr, hh, he))):
            r = recs[j.job_id]
            print(f"  cost record {r.tag}: status {r.status}, backend "
                  f"{r.backend}, passes_over_A {r.passes_over_A}, bytes_per_pass "
                  f"{r.bytes_per_pass}, bytes_moved {r.bytes_moved}, "
                  f"stream_extracts {r.stream_extracts}, batched {r.batched}, "
                  f"error_kind {r.error_kind}, queue_wait_s "
                  f"{r.queue_wait_s:.3f}, run_wall_s {r.run_wall_s:.3f}")
        burst = [r for r in svc.meter.records if r.batched]
        print(f"  cost records of the bursts: {len(burst)} batched, "
              f"passes_over_A {sum(r.passes_over_A or 0 for r in burst)}, "
              f"bytes_moved "
              f"{sum((r.bytes_moved or {}).get('device', 0) for r in burst)}"
              f", {sum(r.status == 'failed' for r in burst)} failed")
        if metrics["jobs"] != 6 + 2 * SV_BURST or metrics["by_status"] != {
                "done": 4 + 2 * (SV_BURST - 1), "failed": 3, "cancelled": 1}:
            fail(f"the service's metrics {metrics}")
        print("service metrics: " + json.dumps(metrics, default=str))
        summary["metrics"] = metrics
        return summary, line_counts

    summary, line_counts = run_service()
    summary["deflate_rmatvec_retime"] = retime
    # the cancelled job, and every other, returned its device memory
    after = settled()
    print(f"device memory with every job's result dropped: {after} bytes "
          f"(before the service: {base})")
    if after != base:
        live = sorted((t.numel() * t.element_size(), tuple(t.shape), t.dtype)
                      for t in gc.get_objects()
                      if isinstance(t, torch.Tensor) and t.is_cuda)
        fail(f"device memory {after} bytes after the service, {base} before; "
             f"live CUDA tensors (bytes, shape, dtype): {live[-12:]}; "
             f"allocator: " + json.dumps({key: val for key, val in
                                          torch.cuda.memory_stats().items()
                                          if key.endswith(".all.current")}))
    del A, Ad, Xb, H
    torch.cuda.empty_cache()

    # -- the kernels line's entries: launches beside the rows at their shapes
    line = []
    for key, c in line_counts.items():
        name, tag = key.split("[", 1)
        kernel = name.split("/")[0]
        if kernel in ("block_matvec", "block_rmatvec", "block_gram_chain"):
            wgmma = name.endswith("/wgmma")
            which = "shard" if "shard" in tag else "host block" if \
                "host-blocked" in tag else "burst bfloat16" if wgmma else \
                "burst float32"
            row = rows[which][kernel]
            source = TC_SOURCE if wgmma else TF32_SOURCE
        else:
            row, source = rows["deflation"][kernel], SOURCES[kernel]
        line.append({"name": key, "route": "cuda", "source": source,
                     "replaces": REPLACES[kernel], "launches": c,
                     **{f: row[f] for f in ("max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "bound_by",
                                            "library_ms")}})
    summary["seconds"] = time.perf_counter() - t_phase
    print(f"phase 11: {summary['seconds']:.1f} s")
    return summary, line


# ---------------------------------------------------------------------------
# phase 12: training (repro_torch.training) on the card
# ---------------------------------------------------------------------------

TR_ARCH = "qwen3-0.6b"
TR_BATCH, TR_SEQ, TR_CHUNKS = 8, 2048, 8   # tokens a step, loss_chunks
TR_STEPS = 10                              # steps plain, then compressed
TR_REMAT_STEPS = 5                         # steps under remat_policy "full"
TR_REMAT_PAIRS = 6                         # "minimal" / "full" pairs in turns
TR_RANK = 8
# compress_ratio at qwen3-0.6b's full width, rank 8, min_size 65536 (the
# JAX package's count): 8 compressed leaves and 6 plain ones
TR_RATIO = 2384199680 / 41213952
TR_LR = 1e-3                               # warmup 2 steps, then cosine
# the restart check (12.3): qwen3-0.6b's widths, 2 layers, 2 x 256 tokens
TR_RESTART_LAYERS, TR_RESTART_TOKENS = 2, (2, 256)
TR_RESTART_STEPS, TR_CKPT_EVERY, TR_FAIL_AT = 8, 4, 5
# card against CPU at smoke size: all ten archs, the dense-attention text
# ones in 12.4, the other families (recurrent, MoE, VLM, audio) in 15.3
TR_CPU_ARCHS = ("gemma2-9b", "qwen3-0.6b", "starcoder2-15b", "yi-6b",
                "recurrentgemma-9b", "rwkv6-1.6b", "grok-1-314b",
                "llama4-scout-17b-a16e", "llava-next-34b", "musicgen-large")
TR_CPU_DENSE, TR_CPU_STEPS = 4, 3
TOL_TRAIN_CPU = 1e-4                       # card vs CPU, smoke size, fp32
TR_CPU_LR = 5e-3                           # 12.4's AdamW lr
# the backward kernel at ragged shapes: (B, H, Hkv, S, window, softcap);
# S is no multiple of the tiles, G = H / Hkv in {2, 8, 1, 8}, windows
# below S, at S and past it
BWD_RAGGED = [(2, 4, 2, 133, 64, 50.0), (1, 8, 1, 70, 70, None),
              (1, 3, 3, 97, 1000, None), (2, 8, 1, 150, 40, 30.0)]
# the path's shapes: (label, B, H, Hkv, S, D, window, softcap)
BWD_PATH = [("qwen3-0.6b", TR_BATCH, 16, 8, TR_SEQ, 128, TR_SEQ, None),
            ("gemma2-9b local", 1, 16, 8, 8192, 256, 4096, 50.0),
            ("gemma2-9b global", 1, 16, 8, 8192, 256, 8192, 50.0)]
BWD_SOURCE = "src/repro_torch/csrc/local_attn_bwd.cu"
# what the backward kernel stands in for: the JAX package differentiates
# its jnp attention (it has no backward kernel)
BWD_REPLACES = "src/repro/models/layers.py:136"


def attn_bwd_bound(B, H, Hkv, S, D, window) -> tuple:
    """Least time of the gradient on an H100 SXM: 10 D flop per live
    (query, key) pair (the scores again, dO V^T, P^T dO, dS K, dS^T Q)
    over the bf16 tensor-core peak, against q, k, v, o, dO and lse read
    once and dQ, dK, dV written once (bf16) over the memory rate."""
    w = min(window, S)
    pairs = B * H * (w * (w + 1) // 2 + (S - w) * w)
    nbytes = 2 * B * S * D * (4 * H + 4 * Hkv) + 4 * B * H * S
    return pick(nbytes / PEAK_BYTES * 1e3,
                pairs * 10 * D / PEAK_OPS["bfloat16"] * 1e3)


def plain_attention_bwd(ref, q, k, v, o, do, lse, window, softcap, each):
    """The backward's plain version one K/V head (its query heads) at a
    time, so the (S, S) tensors stay a few GB; ``each(hk, dq, dk, dv)``
    sees every chunk."""
    G = q.shape[1] // k.shape[1]
    for hk in range(k.shape[1]):
        sl = slice(hk * G, (hk + 1) * G)
        grads = ref.local_attention_bwd_ref(
            q[:, sl], k[:, hk:hk + 1], v[:, hk:hk + 1], o[:, sl], do[:, sl],
            lse[:, sl], window=window, softcap=softcap)
        each(hk, *grads)
        del grads


def bwd_readings(torch, ref, got, q, k, v, o, do, lse, window, softcap,
                 dtype) -> tuple:
    """(max |kernel - plain| over dq, dk, dv; each one's worst share of
    its per-element limit), the plain version by K/V head."""
    G = q.shape[1] // k.shape[1]
    mae, shares = 0.0, [0.0, 0.0, 0.0]

    def each(hk, *want):
        nonlocal mae
        parts = (got[0][:, hk * G:(hk + 1) * G], got[1][:, hk:hk + 1],
                 got[2][:, hk:hk + 1])
        for i, (a, b) in enumerate(zip(parts, want)):
            mae = max(mae, float((a.float() - b).abs().max()))
            shares[i] = max(shares[i], attn_share(a, b, dtype))
    plain_attention_bwd(ref, q, k, v, o, do, lse, window, softcap, each)
    return mae, shares


def attention_bwd_ragged(torch, ops, ref, la, g, dev) -> float:
    """The backward kernel against its plain version at ragged shapes,
    fp32 and bf16, every head dim, on the forward kernel's log-sum-exp
    (itself held to the plain version's within ``TOL_ATTN_FP32``); one
    shape also through the autograd Function (launches: one forward, the
    backward's kernels).  Returns the worst share of a limit."""
    worst = 0.0
    for D in la.HEAD_DIMS:
        for (B, H, Hkv, S, window, softcap) in BWD_RAGGED:
            for sd in ("float32", "bfloat16"):
                dt = getattr(torch, sd)
                q, k, v = attn_inputs(torch, g, dev, B, H, Hkv, S, D, dt)
                do = attn_inputs(torch, g, dev, B, H, Hkv, S, D, dt)[0]
                lse = torch.empty((B, H, S), device=dev)
                o = la.local_attention_cuda(q, k, v, window, softcap, lse)
                route = la.bwd_route(dt, D)
                ops.reset_launches()
                got = ops.local_attention_bwd(q, k, v, o, do, lse,
                                              window=window, softcap=softcap)
                ran = {n: c for n, c in ops.route_launches.items() if c}
                want = ref.local_attention_bwd_ref(q, k, v, o, do, lse,
                                                   window=window,
                                                   softcap=softcap)
                lse_err = float((lse - ref.local_attention_lse_ref(
                    q, k, v, window=window, softcap=softcap)[1]).abs().max())
                torch.cuda.synchronize()
                shares = [attn_share(a, b, sd) for a, b in zip(got, want)]
                label = (f"local_attention_bwd {sd} ({route}) B={B} H={H} "
                         f"Hkv={Hkv} S={S} D={D} window={window} "
                         f"softcap={softcap}")
                print(f"  {label}: dq, dk, dv "
                      f"{', '.join(f'{s:.2f}' for s in shares)} of the "
                      f"per-element limit; forward lse err {lse_err:.1e}")
                ok = all(a.dtype == dt and a.shape == b.shape
                         and bool(torch.isfinite(a).all())
                         for a, b in zip(got, want))
                if not (ok and max(shares) <= 1 and
                        lse_err <= TOL_ATTN_FP32):
                    fail(f"{label}: {shares} of the limit, lse err "
                         f"{lse_err}")
                if ran != {f"local_attention_bwd/{route}": la.BWD_KERNELS}:
                    fail(f"{label}: launches by route {ran}")
                worst = max(worst, *shares)
    # the autograd Function: one forward launch (keeping lse), then the
    # backward's kernels, and the same gradient as the direct call
    B, H, Hkv, S, window, softcap = BWD_RAGGED[0]
    q, k, v = (x.detach().requires_grad_() for x in attn_inputs(
        torch, g, dev, B, H, Hkv, S, 128, torch.bfloat16))
    do = attn_inputs(torch, g, dev, B, H, Hkv, S, 128, torch.bfloat16)[0]
    ops.reset_launches()
    o = ops.local_attention(q, k, v, window=window, softcap=softcap)
    grads = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    counts = {n: c for n, c in ops.launches.items() if c}
    ran = {n: c for n, c in ops.route_launches.items() if c}
    if counts != {"local_attention": 1,
                  "local_attention_bwd": la.BWD_KERNELS} or \
            ran != {"local_attention_bwd/wgmma": la.BWD_KERNELS}:
        fail(f"the autograd Function launched {counts}, by route {ran}")
    lse = torch.empty((B, H, S), device=dev)
    o2 = la.local_attention_cuda(q.detach(), k.detach(), v.detach(), window,
                                 softcap, lse)
    direct = ops.local_attention_bwd(q.detach(), k.detach(), v.detach(), o2,
                                     do, lse, window=window, softcap=softcap)
    if not all(torch.equal(a, b) for a, b in zip(grads, direct)):
        fail("the autograd Function's gradient differs from the direct "
             "backward call")
    print(f"  autograd Function: launches {counts}, gradient bitwise the "
          f"direct call's")
    return worst


def ffma_bwd(torch, la, q, k, v, o, do, lse, window, softcap):
    """The backward's FFMA kernels through their C entry point, whatever
    ``bwd_route`` says (a yardstick: the training path never takes them
    for bf16 at D >= 64)."""
    grads, args, _ = la.bwd_call(q, k, v, o, do, lse, window, softcap)
    err = la._bwd_lib().repro_local_attention_bwd(
        *args, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        fail(f"the FFMA backward's launch failed: CUDA error {err}")
    return grads


def attention_bwd_path(torch, ops, ref, la, g, dev, planted=None,
                       shapes=None) -> dict:
    """The backward kernel at the path's shapes (``BWD_PATH``, bf16, on
    the route ``bwd_route`` names): within its limits, two runs bitwise
    equal, then timed beside its bound, its plain version and, with no cap
    and no window, autograd of ``scaled_dot_product_attention(is_causal=
    True)`` (K/V repeated to every head: a yardstick only).  The qwen3
    row also times the FFMA kernels on the same inputs through their C
    entry point (``ffma_ms``, with their readings: a yardstick, no
    limit), and the forward kernel with its log-sum-exp (training's
    forward) beside its plain version and SDPA's forward.  With
    ``planted`` (phase 1's builds), the qwen3 and gemma2-9b global rows
    also read the ``BWD_PLANTED`` builds of the tensor-core route on the
    same inputs (printed: what two bf16 terms, or sums left in the tensor
    cores, would cost against the limit).  ``shapes``: other entries of
    ``BWD_PATH``'s form (phase 16's local heads)."""
    import torch.nn.functional as F
    rows = {}
    for (label, B, H, Hkv, S, D, window, softcap) in shapes or BWD_PATH:
        q, k, v = attn_inputs(torch, g, dev, B, H, Hkv, S, D, torch.bfloat16)
        do = attn_inputs(torch, g, dev, B, H, Hkv, S, D, torch.bfloat16)[0]
        lse = torch.empty((B, H, S), device=dev)
        o = la.local_attention_cuda(q, k, v, window, softcap, lse)
        bwd = lambda: ops.local_attention_bwd(q, k, v, o, do, lse,
                                              window=window, softcap=softcap)
        got, again = bwd(), bwd()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        mae, shares = bwd_readings(torch, ref, got, q, k, v, o, do, lse,
                                   window, softcap, "bfloat16")
        del got
        if not same or max(shares) > 1:
            fail(f"local_attention_bwd {label}: shares {shares}, reruns "
                 f"bitwise equal: {same}")
        row = {"route": la.bwd_route(q.dtype, D), "max_abs_err": mae,
               "shares_of_limit": shares, "reruns_bitwise": same,
               "ms": time_ms(torch, bwd, 5 if S <= 2048 else 3),
               "plain_ms": time_ms(torch, lambda: plain_attention_bwd(
                   ref, q, k, v, o, do, lse, window, softcap,
                   lambda *a: None), 1),
               "library_ms": None}
        row["bound_ms"], row["bound_by"] = attn_bwd_bound(B, H, Hkv, S, D,
                                                          window)
        for (lib, flag), path in (planted or {}).items():
            if (lib, flag) not in BWD_PLANTED or window < S:
                continue
            f_mae, f_shares = planted_run(la, lib, path, lambda: bwd_readings(
                torch, ref, bwd(), q, k, v, o, do, lse, window, softcap,
                "bfloat16"))
            row[f"shares_{flag.lower()}"] = f_shares
            print(f"  planted -D{flag} (the tensor-core route) bf16 {label}: "
                  f"max abs err {f_mae:.2e}, dq, dk, dv "
                  f"{', '.join(f'{x:.2f}' for x in f_shares)} of the "
                  f"per-element limit")
        G = H // Hkv
        if softcap is None and window >= S:
            ffma = lambda: ffma_bwd(torch, la, q, k, v, o, do, lse, window,
                                    softcap)
            f_mae, f_shares = bwd_readings(torch, ref, ffma(), q, k, v, o,
                                           do, lse, window, softcap,
                                           "bfloat16")
            row.update(ffma_ms=time_ms(torch, ffma, 2), ffma_max_abs_err=f_mae,
                       ffma_shares_of_limit=f_shares)
            print(f"  FFMA backward (yardstick, its C entry point) bf16 "
                  f"{label}: {row['ffma_ms']:.3f} ms, max abs err "
                  f"{f_mae:.2e}, dq, dk, dv "
                  f"{', '.join(f'{x:.2f}' for x in f_shares)} of the "
                  f"per-element limit")
            qc = q.contiguous().requires_grad_()
            kr = k.repeat_interleave(G, dim=1).contiguous().requires_grad_()
            vr = v.repeat_interleave(G, dim=1).contiguous().requires_grad_()
            out = F.scaled_dot_product_attention(qc, kr, vr, is_causal=True)
            doc = do.contiguous()
            row["library_ms"] = time_ms(torch, lambda: torch.autograd.grad(
                out, (qc, kr, vr), doc, retain_graph=True), 5)
            fwd = {"ms": time_ms(torch, lambda: la.local_attention_cuda(
                       q, k, v, window, softcap, lse), 10),
                   "plain_ms": time_ms(torch, lambda: plain_attention(
                       ref, q, k, v, window, softcap), 1),
                   "library_ms": time_ms(
                       torch, lambda: F.scaled_dot_product_attention(
                           qc, kr, vr, is_causal=True), 10)}
            o_mae, (o_share,) = attn_readings(torch, ref, [o], q, k, v,
                                              window, softcap)
            if o_share > 1:
                fail(f"local_attention (with lse) {label}: {o_share} of "
                     f"the per-element limit")
            fwd["max_abs_err"] = o_mae
            fwd["bound_ms"], fwd["bound_by"] = attn_bound(B, H, Hkv, S, D,
                                                          window)
            rows[f"forward {label}"] = fwd
            print(f"  local_attention with lse, bf16 {label} B={B} H={H} "
                  f"Hkv={Hkv} S={S} D={D}: max abs err {o_mae:.2e} "
                  f"({o_share:.2f} of the limit), kernel {fwd['ms']:.3f} ms, "
                  f"plain {fwd['plain_ms']:.1f} ms, SDPA is_causal "
                  f"{fwd['library_ms']:.3f} ms, bound {fwd['bound_ms']:.3f} "
                  f"ms ({fwd['bound_by']})")
            del qc, kr, vr, out, doc
        rows[label] = row
        print(f"  local_attention_bwd bf16 ({row['route']}) {label} B={B} "
              f"H={H} Hkv={Hkv} S={S} D={D} window={window} "
              f"softcap={softcap}: max abs err "
              f"{mae:.2e}, dq, dk, dv {', '.join(f'{s:.2f}' for s in shares)} "
              f"of the per-element limit, reruns bitwise equal; kernel "
              f"{row['ms']:.3f} ms, plain {row['plain_ms']:.1f} ms, bound "
              f"{row['bound_ms']:.3f} ms ({row['bound_by']}), autograd of "
              f"SDPA " + ("-" if row["library_ms"] is None else
                          f"{row['library_ms']:.3f} ms (is_causal=True)"))
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return rows


def tree_to(tree, where):
    """A state tree (``TrainState.tree()``) cloned onto ``where``."""
    if isinstance(tree, dict):
        return {key: tree_to(val, where) for key, val in tree.items()}
    return None if tree is None else tree.detach().to(where).clone()


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in tree_leaves(tree[key])]
    return [] if tree is None else [tree]


# a hand-written kernel's forward launches in a train step, by
# remat_policy: once, and again in the recompute of a checkpointed layer.
# The kernels fill their outputs through ctypes, out of the dispatcher's
# sight, so "minimal" (which saves the outputs of aten.mm/addmm alone)
# recomputes them as "full" does
KERNEL_FORWARDS = {"none": 1, "minimal": 2, "full": 2}


def train_expected(cfg, micro: int, n_comp: int) -> dict:
    """The kernels one train step launches, by its accounting: the
    attention forward once an attention layer and again in the remat
    recompute (``KERNEL_FORWARDS``), the backward's kernels once such a
    layer; a recurrent layer's recurrence (``rglru_scan``, ``wkv6``)
    likewise and its backward kernel once; and with compression one
    ``block_matvec`` and one ``block_rmatvec`` a compressed leaf, on
    ``tf32x3``."""
    from repro_torch.kernels import local_attn
    remat = KERNEL_FORWARDS[cfg.remat_policy]
    n_attn = sum(kind in ("attn", "local") for kind in cfg.blocks)
    n_rglru, n_rwkv = cfg.blocks.count("rglru"), cfg.blocks.count("rwkv")
    return {"local_attention": n_attn * remat * micro,
            "local_attention_bwd": n_attn * local_attn.BWD_KERNELS * micro,
            "rglru_scan": n_rglru * remat * micro,
            "rglru_scan_bwd": n_rglru * micro,
            "wkv6": n_rwkv * remat * micro,
            "wkv6_bwd": n_rwkv * micro,
            "block_matvec": n_comp,
            "block_rmatvec": n_comp}


# cuBLAS's GEMM kernels on the card, by name (the port's own kernels are
# named local_attn*, bwd_*, *_tf32, *_tc, rglru_*, wkv6_*)
GEMM_NAME = re.compile(r"gemm|nvjet|xmma|gemv", re.I)


def train_run(torch, ops, dev, cfg, tc, batches, profile=False,
              first_again=False) -> dict:
    """``init_train_state`` and ``len(batches)`` calls of the train step
    (the entry points a user calls), each step's launches checked
    against ``train_expected``; then, with ``first_again``, one more step
    on the first batch (its loss, from the trained parameters, as
    ``first_loss_after``); with ``profile``, one more step under the
    profiler."""
    from repro_torch.kernels import local_attn
    from repro_torch.models.convert import leaf_layout
    from repro_torch.optim.compression import _mat_shape
    from repro_torch.training import init_train_state, make_train_step
    state = init_train_state(cfg, tc, device=dev)
    step = make_train_step(cfg, tc)
    comp_shapes = [(leaf.path, *_mat_shape(leaf.shape))
                   for leaf in leaf_layout(state.model)
                   if state.comp is not None and leaf.path in state.comp["Q"]]
    want = train_expected(cfg, tc.microbatches, len(comp_shapes))
    bwd_route = local_attn.bwd_route(getattr(torch, cfg.dtype),
                                     cfg.head_dim)
    routes = {name: c for name, c in (
        (f"local_attention_bwd/{bwd_route}", want["local_attention_bwd"]),
        ("block_matvec/tf32x3", want["block_matvec"]),
        ("block_rmatvec/tf32x3", want["block_rmatvec"])) if c}
    losses, ms, totals = [], [], {}
    torch.cuda.reset_peak_memory_stats()
    for i, batch in enumerate(batches):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        got = {n: c for n, c in ops.launches.items() if c}
        got_routes = {n: c for n, c in ops.route_launches.items() if c}
        if got != {n: c for n, c in want.items() if c} or \
                got_routes != routes:
            fail(f"train step {i}: launches {got}, by route {got_routes}; "
                 f"the accounting says {want}, {routes}")
        for n, c in got.items():
            totals[n] = totals.get(n, 0) + c
    out = {"losses": losses, "ms_steps": ms, "launches": totals,
           "comp_shapes": comp_shapes,
           "launches_per_step": want,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "compress_ratio": (float(metrics["compress_ratio"])
                              if "compress_ratio" in metrics else None)}
    if first_again:
        _, metrics = step(state, batches[0])
        out["first_loss_after"] = float(metrics["loss"])
    if profile:
        calls = {}
        _, wall, busy, n, by_name = profile_window(
            torch, lambda: step(state, batches[-1]), calls)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        share = lambda key: sum(t for nm, t in by_name.items()
                                if key in nm) / max(busy, 1e-12)
        # the attention backward's kernels by name: delta and the
        # route's two (the recurrences' backward kernels apart)
        import re
        rec = ("rglru_scan_bwd", "wkv6_bwd")
        bwd_ms = {re.search(r"bwd_\w+<[^>]*>", nm).group(0): t * 1e3
                  for nm, t in by_name.items()
                  if "bwd_" in nm and not any(r in nm for r in rec)}
        want_bwd = sorted(
            f"{k}<{cfg.head_dim}>" if k.endswith("wgmma") else
            f"{k}<__nv_bfloat16, {cfg.head_dim}>"
            for k in (("bwd_delta", "bwd_dkdv_wgmma", "bwd_dq_wgmma")
                      if bwd_route == "wgmma" else
                      ("bwd_delta", "bwd_dkdv", "bwd_dq")))
        if sorted(bwd_ms) != (want_bwd if want["local_attention_bwd"]
                              else []):
            fail(f"the profiled step's backward kernels: {sorted(bwd_ms)}")
        rec_ms = {nm[:60]: t * 1e3 for nm, t in by_name.items()
                  if any(r in nm for r in rec)}
        if sorted(r for r in rec if any(r in nm for nm in rec_ms)) != \
                sorted(r for r in rec if want[r]):
            fail(f"the profiled step's recurrence backward kernels: "
                 f"{sorted(rec_ms)}")
        out["profile"] = {
            # the step's GEMMs, cuBLAS's kernels by name (the host's
            # aten::mm events cannot count them: the profiler records an
            # op that a selective checkpoint answers from its saved
            # outputs, and records twice one it runs)
            "gemm_launches": sum(c for nm, c in calls.items()
                                 if GEMM_NAME.search(nm)),
            "gemm_ms": sum(t for nm, t in by_name.items()
                           if GEMM_NAME.search(nm)) * 1e3,
            "gemm_names": sorted({nm[:48] for nm in calls
                                  if GEMM_NAME.search(nm)})[:6],
            "wall_ms": wall * 1e3, "busy_ms": busy * 1e3,
            "busy_share": busy / wall, "activities": n,
            "attention_bwd_ms": bwd_ms,
            "attention_bwd_share": sum(t for nm, t in by_name.items()
                                       if "bwd_" in nm and not any(
                                           r in nm for r in rec))
            / max(busy, 1e-12),
            "attention_fwd_share": share("local_attn"),
            "recurrence_bwd_ms": rec_ms,
            "recurrence_bwd_share": share("rglru_scan_bwd")
            + share("wkv6_bwd"),
            "wkv6_bwd_share": share("wkv6_bwd"),
            "recurrence_fwd_share": share("rglru_scan_kernel")
            + share("wkv6_kernel"),
            "sweeps_share": share("tf32"),
            "top_ms": {nm[:60]: t * 1e3 for nm, t in top}}
    del state
    torch.cuda.empty_cache()
    return out


def compression_sweeps(torch, ops, ref, bm, dev, shapes) -> dict:
    """``block_matvec`` (``M Q``) and ``block_rmatvec`` (``M^T P``) at the
    compression's shapes (``shapes``: (leaf, p, q) of each compressed
    leaf; rank 8, fp32, random M), each against its plain version, timed
    beside its bound and ``torch.matmul``; the rows sum the shapes' times
    (one step's sweeps)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    sums = {name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                   "bound_ms": 0.0, "max_abs_err": 0.0, "shapes": []}
            for name in ("block_matvec", "block_rmatvec")}
    for path, p, qd in shapes:
        M = torch.randn((p, qd), generator=g, device=dev)
        Q = torch.linalg.qr(torch.randn((qd, TR_RANK), generator=g,
                                        device=dev)).Q
        P = torch.linalg.qr(torch.randn((p, TR_RANK), generator=g,
                                        device=dev)).Q
        for name, kern, plain, lib in (
                ("block_matvec", lambda: ops.block_matvec(M, Q),
                 lambda: ref.block_matvec_ref(M, Q), lambda: M @ Q),
                ("block_rmatvec", lambda: ops.block_rmatvec(M, P),
                 lambda: ref.block_rmatvec_ref(M, P), lambda: M.mT @ P)):
            if bm.route(M, TR_RANK) != "tf32x3":
                fail(f"{name} at {(p, qd)}: route {bm.route(M, TR_RANK)}")
            got, want = kern(), plain()
            e = rel_err(torch, got, want)
            if not e <= TOL["float32"]:
                fail(f"{name} at {(p, qd)}: rel err {e}")
            row = sums[name]
            t = {"ms": time_ms(torch, kern, 10),
                 "plain_ms": time_ms(torch, plain, 10),
                 "library_ms": time_ms(torch, lib, 10),
                 "bound_ms": bound(name, p, qd, TR_RANK, "float32",
                                   "tf32x3")[0]}
            for key, val in t.items():
                row[key] += val
            row["max_abs_err"] = max(row["max_abs_err"],
                                     float((got - want).abs().max()))
            row["shapes"].append({"leaf": path, "m": p, "n": qd,
                                  "rel_err": e, **t})
            print(f"  {name:13s} {path:22s} ({p} x {qd}, k {TR_RANK}): "
                  f"rel err {e:.1e}, kernel {t['ms']:.3f} ms, plain "
                  f"{t['plain_ms']:.3f} ms, torch.matmul "
                  f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms")
        del M, Q, P
    for row in sums.values():
        # the sum of the shapes' bounds; by bytes at every shape (k = 8)
        row["bound_by"] = "bytes"
    torch.cuda.empty_cache()
    return sums


def remat_turns(torch, dev, cfg, tc, batches) -> dict:
    """12.2's remat pair timed in turns on one card: a state under
    ``remat_policy`` "minimal" and one under "full", from the same init,
    stepping on the same batches in ``TR_REMAT_PAIRS`` pairs whose order
    alternates (after a warm-up step each); ms a step by policy, and the
    pairs "minimal" won."""
    import dataclasses
    from repro_torch.training import init_train_state, make_train_step
    cfgs = {"minimal": cfg, "full": dataclasses.replace(
        cfg, remat_policy="full")}
    states = {k: init_train_state(c, tc, device=dev) for k, c in cfgs.items()}
    steps = {k: make_train_step(c, tc) for k, c in cfgs.items()}
    ms = {k: [] for k in cfgs}
    for i in range(TR_REMAT_PAIRS + 1):
        order = ("minimal", "full") if i % 2 else ("full", "minimal")
        for k in order:
            torch.cuda.synchronize()
            t = time.perf_counter()
            states[k], m = steps[k](states[k], batches[i])
            float(m["loss"])
            torch.cuda.synchronize()
            if i:                        # the first pair warms up
                ms[k].append((time.perf_counter() - t) * 1e3)
    del states
    torch.cuda.empty_cache()
    med = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
    wins = sum(a < b for a, b in zip(ms["minimal"], ms["full"]))
    print(f"  {cfg.name} remat in turns ({TR_REMAT_PAIRS} pairs, order "
          f"alternating): 'minimal' " + ", ".join(f"{x:.1f}" for x in
                                                ms["minimal"])
          + " ms, 'full' " + ", ".join(f"{x:.1f}" for x in ms["full"])
          + f" ms; medians {med['minimal']:.1f} / {med['full']:.1f}; "
          f"'minimal' faster in {wins} of {TR_REMAT_PAIRS} pairs")
    return {"ms": ms, "median_ms": med, "minimal_wins": wins}


def train_restart(torch, dev) -> dict:
    """12.3: the runner with a failure planted before step ``TR_FAIL_AT``
    and a checkpoint every ``TR_CKPT_EVERY`` steps, against an
    uninterrupted run: every step's loss and the final parameters,
    moments and compression state bitwise equal."""
    import dataclasses
    import tempfile
    from repro_torch import configs
    from repro_torch.data import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compression import CompressionConfig
    from repro_torch.training import TrainConfig
    from repro_torch.training.runner import RunnerConfig, TrainingRunner
    cfg = dataclasses.replace(configs.get_config(TR_ARCH),
                              num_layers=TR_RESTART_LAYERS, loss_chunks=2)
    tc = TrainConfig(adamw=AdamWConfig(lr=TR_LR, warmup_steps=2,
                                       total_steps=TR_RESTART_STEPS),
                     compression=CompressionConfig(rank=TR_RANK))
    B, S = TR_RESTART_TOKENS
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)
    fired = []

    def plant(step):
        if step == TR_FAIL_AT and not fired:
            fired.append(step)
            raise RuntimeError(f"planted failure before step {step}")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        runs = {}
        for label, hook in (("uninterrupted", None), ("restarted", plant)):
            rc = RunnerConfig(total_steps=TR_RESTART_STEPS,
                              ckpt_every=TR_CKPT_EVERY,
                              ckpt_dir=os.path.join(d, label),
                              max_restarts=1 if hook else 0)
            runner = TrainingRunner(cfg, tc, rc, dc, failure_hook=hook,
                                    device=dev)
            state = runner.run()
            runs[label] = (runner, state.tree())
    (ra, ta), (rb, tb) = runs["uninterrupted"], runs["restarted"]
    la = {h["step"]: h["loss"] for h in ra.history}
    lb = {h["step"]: h["loss"] for h in rb.history}
    replayed = [h["loss"] for h in rb.history if h["step"] == TR_CKPT_EVERY]

    same = all(torch.equal(a.detach(), b.detach())
               for a, b in zip(tree_leaves(ta), tree_leaves(tb)))
    out = {"restarts": rb.restarts, "losses_bitwise": la == lb,
           "replayed_step_bitwise": len(set(replayed)) == 1,
           "state_bitwise": same, "leaves": len(tree_leaves(ta)),
           "seconds": time.perf_counter() - t0}
    print(f"  restart: a failure before step {TR_FAIL_AT}, checkpoints every "
          f"{TR_CKPT_EVERY} steps ({cfg.num_layers} layers of "
          f"{TR_ARCH}, {B} x {S} tokens, compressed): restarts "
          f"{rb.restarts}, every loss bitwise {out['losses_bitwise']}, "
          f"final state ({out['leaves']} tensors) bitwise {same} "
          f"({out['seconds']:.1f} s)")
    if not (rb.restarts == 1 and out["losses_bitwise"] and same
            and out["replayed_step_bitwise"]):
        fail(f"the resumed run is not the uninterrupted one: {out}")
    return out


def train_card_vs_cpu(torch, dev, archs, modes=(False, True)) -> dict:
    """12.4 and 15.3 (plain; ``modes``: compression off, on): the smoke
    configs (fp32) of ``archs`` trained ``TR_CPU_STEPS`` steps on
    the card and on ``device="cpu"`` from the same state (made on the
    CPU and copied), plain and compressed: every loss within
    ``TOL_TRAIN_CPU``, and each parameter tensor within
    ``TOL_TRAIN_CPU`` of its norm (Frobenius).  Not element by element:
    a few entries of a smoke model's gradient sum to ~1e-9 (cancelling
    terms; 7 of 60k here), where AdamW's first update ``g / (|g| +
    eps)`` turns the sums' rounding on either device into up to ``lr``
    (on an H100 the worst single entry moved 3.6e-4 plain and 4.7e-4
    compressed at lr 5e-3); a wrong gradient moves whole tensors by
    ~``lr`` an entry, 1e-2 of their norm.  The largest single entry's
    difference is printed beside."""
    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compression import CompressionConfig
    from repro_torch.training import (TrainConfig, init_train_state,
                                      make_train_step)

    out = {}
    for arch, enabled in ((a, e) for a in archs for e in modes):
        cfg = configs.smoke_config(configs.get_config(arch))
        tc = TrainConfig(adamw=AdamWConfig(lr=TR_CPU_LR, warmup_steps=1,
                                           total_steps=TR_CPU_STEPS),
                         compression=CompressionConfig(
                             enabled=enabled, rank=TR_RANK, min_size=512))
        sc = init_train_state(cfg, tc, device="cpu")
        sg = init_train_state(cfg, tc, device=dev)
        sg.load_tree(tree_to(sc.tree(), dev))
        ds = SyntheticLMDataset(DataConfig(
            cfg.vocab_size, 32, 4, family=cfg.family,
            num_codebooks=cfg.num_codebooks,
            patch_positions=cfg.patch_positions, d_model=cfg.d_model))
        step_c, step_g = make_train_step(cfg, tc), make_train_step(cfg, tc)
        loss_err = 0.0
        for i in range(TR_CPU_STEPS):
            sc, mc = step_c(sc, ds.batch(i))
            sg, mg = step_g(sg, ds.batch(i))
            loss_err = max(loss_err, abs(float(mc["loss"])
                                         - float(mg["loss"])))
        pc = dict(sc.model.named_parameters())
        rel = entry = 0.0
        worst = ""
        for n, p in sg.model.named_parameters():
            d = p.detach().cpu() - pc[n].detach()
            r = float(d.norm() / pc[n].detach().norm())
            if r > rel:
                rel, worst = r, n
            entry = max(entry, float(d.abs().max()))
        label = f"{arch} {'compressed' if enabled else 'plain'}"
        out[label] = {"loss_err": loss_err, "param_rel_err": rel,
                      "param_max_entry_err": entry, "param_worst": worst}
        print(f"  {cfg.name} fp32, {TR_CPU_STEPS} "
              f"{'compressed' if enabled else 'plain'} steps at lr "
              f"{TR_CPU_LR} on the card and on the CPU: loss diff "
              f"{loss_err:.1e}, parameters {rel:.1e} of their norm ({worst};"
              f" limit {TOL_TRAIN_CPU:.0e} for both), largest single entry "
              f"{entry:.1e}")
        if not (loss_err <= TOL_TRAIN_CPU and rel <= TOL_TRAIN_CPU):
            fail(f"{label} smoke: card vs CPU {out[label]}")
    return out


def training(torch, ops, ref, la, bm, dev, planted=None) -> tuple:
    """Phase 12; returns (its summary, its rows of the ``kernels``
    line)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compression import CompressionConfig
    from repro_torch.training import TrainConfig
    g = torch.Generator(device=dev).manual_seed(SEED + 42)
    t0 = time.perf_counter()
    worst = attention_bwd_ragged(torch, ops, ref, la, g, dev)
    print(f"backward kernel at ragged shapes: all within limits (worst "
          f"{worst:.2f} of limit)")
    path = attention_bwd_path(torch, ops, ref, la, g, dev, planted)
    t_kernels = time.perf_counter() - t0

    # 12.2 qwen3-0.6b at full width and depth
    cfg = dataclasses.replace(configs.get_config(TR_ARCH),
                              loss_chunks=TR_CHUNKS)
    ds = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=TR_SEQ, global_batch=TR_BATCH))
    batches = [ds.batch(i) for i in range(TR_STEPS)]
    runs = {}
    for label, enabled in (("plain", False), ("compressed", True)):
        tc = TrainConfig(adamw=AdamWConfig(lr=TR_LR, warmup_steps=2,
                                           total_steps=TR_STEPS),
                         compression=CompressionConfig(enabled=enabled,
                                                       rank=TR_RANK))
        r = train_run(torch, ops, dev, cfg, tc, batches, profile=True)
        ms = sorted(r["ms_steps"][1:])[len(r["ms_steps"][1:]) // 2]
        r.update(ms_step=ms, tokens_s=TR_BATCH * TR_SEQ / (ms / 1e3))
        runs[label] = r
        print(f"  {cfg.name} {label}: {cfg.num_layers} layers, "
              f"{TR_BATCH} x {TR_SEQ} tokens a step, bf16 parameters, fp32 "
              f"moments, loss_chunks {TR_CHUNKS}: loss "
              + " ".join(f"{x:.4f}" for x in r["losses"])
              + f"; {ms:.1f} ms a step (median of steps 2-{TR_STEPS}; the "
              f"first {r['ms_steps'][0]:.0f} ms), {r['tokens_s']:.0f} "
              f"tokens/s, peak {r['peak_gb']:.2f} GB; launches a step "
              f"{r['launches_per_step']}")
        if not r["losses"][-1] < r["losses"][0]:
            fail(f"{label} training: the loss did not fall: {r['losses']}")
    # the same step under remat_policy "full" (the whole layer
    # recomputed), against the default "minimal" (the weight GEMMs'
    # outputs saved): fewer GEMMs a step, more memory
    # (the plain run above is "minimal", the configs' default)
    tc = TrainConfig(adamw=AdamWConfig(lr=TR_LR, warmup_steps=2,
                                       total_steps=TR_STEPS),
                     compression=CompressionConfig(enabled=False))
    remat = {"minimal": runs["plain"],
             "full": train_run(torch, ops, dev, dataclasses.replace(
                 cfg, remat_policy="full"), tc, batches[:TR_REMAT_STEPS],
                 profile=True)}
    remat["full"]["ms_step"] = sorted(remat["full"]["ms_steps"][1:])[
        (TR_REMAT_STEPS - 1) // 2]
    for label, r in remat.items():
        p = r["profile"]
        print(f"  {cfg.name} remat_policy {label!r}: {r['ms_step']:.1f} ms a "
              f"step (median of steps 2-{len(r['ms_steps'])}), peak "
              f"{r['peak_gb']:.2f} GB; the profiled step: "
              f"{p['gemm_launches']} cuBLAS GEMM launches "
              f"({p['gemm_ms']:.1f} ms) of {p['activities']} device "
              f"activities, busy {p['busy_ms']:.1f} of {p['wall_ms']:.1f} "
              f"ms; GEMM kernels {p['gemm_names']}")
    if remat["full"]["losses"] != runs["plain"]["losses"][:TR_REMAT_STEPS]:
        fail(f"12.2: remat 'full' losses {remat['full']['losses']} are not "
             f"'minimal''s {runs['plain']['losses'][:TR_REMAT_STEPS]}")
    pm, pf = remat["minimal"]["profile"], remat["full"]["profile"]
    if not 0 < pm["gemm_launches"] < pf["gemm_launches"]:
        fail(f"12.2: remat 'minimal' launches {pm['gemm_launches']} GEMMs a "
             f"step, 'full' {pf['gemm_launches']} (the profiled step's "
             f"top kernels: {pm['top_ms']})")
    turns = remat_turns(torch, dev, cfg, tc, batches)
    comp_run = runs["compressed"]
    ratio = comp_run["compress_ratio"]
    if ratio != float(torch.tensor(TR_RATIO, dtype=torch.float32)):
        fail(f"compress_ratio {ratio}, want {TR_RATIO}")
    prof = comp_run["profile"]
    comp_share = 1 - runs["plain"]["ms_step"] / comp_run["ms_step"]
    print(f"  compress_ratio {ratio} (= {TR_RATIO:.6f}); one compressed "
          f"step under the profiler: {prof['wall_ms']:.0f} ms, device busy "
          f"{prof['busy_share']:.1%}; attention backward "
          f"{prof['attention_bwd_share']:.1%} of the busy time, forward "
          f"{prof['attention_fwd_share']:.1%}, the compression's sweeps "
          f"{prof['sweeps_share']:.2%}; the compression adds {comp_share:.1%} "
          f"to a step's time; top kernels (ms) {prof['top_ms']}")
    sweeps = compression_sweeps(torch, ops, ref, bm, dev,
                                comp_run["comp_shapes"])

    # 12.3 restart; 12.4 card against the CPU
    restart = train_restart(torch, dev)
    cpu = train_card_vs_cpu(torch, dev, TR_CPU_ARCHS[:TR_CPU_DENSE])

    launches = {n: runs["plain"]["launches"].get(n, 0)
                + comp_run["launches"].get(n, 0)
                for n in set(runs["plain"]["launches"])
                | set(comp_run["launches"])}
    q_row, f_row = path["qwen3-0.6b"], path["forward qwen3-0.6b"]
    line_rows = [
        (f"local_attention_bwd/{q_row['route']}", BWD_SOURCE, BWD_REPLACES,
         launches["local_attention_bwd"], q_row),
        ("local_attention[training]", SOURCES["local_attention"],
         REPLACES["local_attention"], launches["local_attention"], f_row),
        ("block_matvec/tf32x3[compression]", TF32_SOURCE,
         REPLACES["block_matvec"], comp_run["launches"]["block_matvec"],
         sweeps["block_matvec"]),
        ("block_rmatvec/tf32x3[compression]", TF32_SOURCE,
         REPLACES["block_rmatvec"], comp_run["launches"]["block_rmatvec"],
         sweeps["block_rmatvec"])]
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": n,
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"]}
               for name, src, rep, n, row in line_rows]
    for k in kernels:
        if not k["launches"]:
            fail(f"{k['name']} was not launched by the training path")
    summary = {"kernel_checks_s": t_kernels, "backward_path": path,
               "runs": {label: {key: r[key] for key in (
                   "losses", "ms_step", "tokens_s", "peak_gb", "launches",
                   "launches_per_step", "compress_ratio", "ms_steps")}
                   for label, r in runs.items()},
               "profile": prof, "compression_step_share": comp_share,
               "remat": {**{label: {key: r[key] for key in (
                   "losses", "ms_step", "ms_steps", "peak_gb", "profile")}
                   for label, r in remat.items()}, "turns": turns},
               "compression_sweeps": sweeps,
               "restart": restart, "card_vs_cpu": cpu}
    return summary, kernels


def analysis(torch, repro_torch, ops, dev, step_s=None) -> dict:
    """Phase 13: the static contract checker on the card, its memory
    estimate against the allocator, the paper-scale dry run and the
    examples (the dry run and the examples run as processes of their
    own, started first, beside 13.1 and 13.2)."""
    import tempfile
    from repro_torch.analysis import run_all
    from repro_torch.analysis.trace_check import trace_step
    from repro_torch.core.config import SVDConfig
    from repro_torch.core.operator import DenseOperator
    from repro_torch.core.svd import init_state, step

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    # six processes beside this one on the host's cores: two threads each
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=src + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else ""))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_analysis_")
    dry_out = os.path.join(tmp, "svd_dryrun_torch.json")
    import threading
    procs, secs, t_launch = {}, {}, time.perf_counter()

    def waiter(name, proc):
        proc.wait()
        secs[name] = time.perf_counter() - t_launch

    threads = []
    for name, args in (("svd_dryrun", ("repro_torch.launch.svd_dryrun",
                                       "--out", dry_out)),
                       *((name, (f"repro_torch.examples.{name}",))
                         for name in EXAMPLES)):
        with open(os.path.join(tmp, f"{name}.log"), "w") as log:
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", *args], stdout=log,
                stderr=subprocess.STDOUT, env=env, cwd=tmp,
                start_new_session=True)
        threads.append(threading.Thread(target=waiter,
                                        args=(name, procs[name])))
        threads[-1].start()
    summary: dict = {}
    try:
        # -- 13.1 every target on the card -------------------------------
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rep = run_all(device="cuda")
        census: dict = {}
        for c in rep.checks:
            if c.pass_name == "trace":
                for key, n in c.details.get("launches", {}).items():
                    if "/" in key:
                        census[key] = census.get(key, 0) + n
        traced = [c.target for c in rep.checks if c.pass_name == "trace"
                  and "launches" in c.details]
        print(f"13.1 run_all(device='cuda'): {len(rep.checks)} checks in "
              f"{time.perf_counter() - t0:.1f} s, {len(traced)} targets "
              f"traced on the card, {len(rep.allowed)} allowlisted, "
              f"{len(rep.failures)} violations; route census {census}")
        for v in rep.violations:
            print(f"  {v}")
        if not rep.ok:
            fail(f"phase 13.1: {len(rep.failures)} contract violations")
        acct = {c.target.split(":", 1)[1]: c.details for c in rep.checks
                if c.target.startswith("accounting:")}
        for name, d in acct.items():
            print(f"  A-traffic {name}: kernels' tally {d['measured_bytes']} "
                  f"bytes, accounting {d['expected_bytes']} ({d['source']})")
            if d["measured_bytes"] != d["expected_bytes"]:
                fail(f"phase 13.1: A-traffic of {name} is "
                     f"{d['measured_bytes']}, its accounting "
                     f"{d['expected_bytes']}")
        if len(acct) != 12 or not any(k.endswith(("/wgmma", "/wgmma_ld"))
                                      for k in census) or not any(
                k.endswith(("/tf32x3", "/tf32x3_cpasync")) for k in census):
            fail(f"phase 13.1: groups {sorted(acct)}, census {census}")
        summary["run_all"] = {"checks": len(rep.checks),
                              "allowlisted": len(rep.allowed),
                              "census": census}

        # -- 13.2 the memory estimate against the allocator ----------------
        g = torch.Generator(device=dev).manual_seed(SEED + 13)
        A = torch.randn(MEM_SHAPE, generator=g, device=dev)
        summary["memory"] = {}
        for sd in ("float32", "bfloat16"):
            op = DenseOperator(A, sweep_dtype=sd)
            cfg = SVDConfig(force_iters=True, sweep_dtype=sd)
            state = init_state(op, K, cfg)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            tr = trace_step(step, op, state, cfg)
            measured = torch.cuda.max_memory_allocated()
            # the estimate counts the step's inputs; the allocator also
            # holds whatever else is live in the process
            estimate = tr.peak_live_bytes + (base - tr.resident_bytes)
            diff = estimate - measured
            print(f"13.2 block step {MEM_SHAPE[0]}x{MEM_SHAPE[1]} {sd}: peak "
                  f"estimate {tr.peak_live_bytes} bytes (inputs "
                  f"{tr.resident_bytes}, the step's own "
                  f"{tr.peak_live_bytes - tr.resident_bytes}), other live "
                  f"{base - tr.resident_bytes}; max_memory_allocated "
                  f"{measured}; estimate - measured {diff} bytes (limit "
                  f"+-{TOL_MEM_BYTES}); launches {tr.launches}")
            summary["memory"][sd] = {"estimate": estimate,
                                     "measured": measured, "diff": diff}
            # a planted fault: the estimate without the step's own
            # storages (inputs and other live bytes alone) must fail
            blind = base - measured
            print(f"  planted: an estimate blind to the step's own storages "
                  f"would be {blind} bytes off (limit +-{TOL_MEM_BYTES})")
            summary["memory"][sd]["blind_diff"] = blind
            if abs(diff) > TOL_MEM_BYTES:
                fail(f"phase 13.2 {sd}: the peak estimate is {diff} bytes "
                     f"off max_memory_allocated")
            if abs(blind) <= TOL_MEM_BYTES:
                fail(f"phase 13.2 {sd}: an estimate blind to the step's own "
                     f"storages ({blind} bytes off) passes the limit")
            del op, state, tr
        del A
        torch.cuda.empty_cache()

        # -- 13.3 the dry run, 13.4 the examples -----------------------------
        for t in threads:
            t.join(timeout=300)
        for name, proc in procs.items():
            with open(os.path.join(tmp, f"{name}.log")) as f:
                out = f.read()
            if proc.returncode != 0:
                fail(f"phase 13: {name} exited {proc.returncode}:\n"
                     f"{out[-4000:]}")
            if name != "svd_dryrun":
                print(f"13.4 example {name}: exit 0, {secs[name]:.1f} s from "
                      f"the phase's start; last line: "
                      f"{out.strip().splitlines()[-1][:160]}")
        with open(dry_out) as f:
            dry = json.load(f)
        keep = ("flops", "sweep_flops", "qr_flops_closed_form", "a_bytes",
                "collective_bytes_by_op", "all_reduce_payloads")
        line = {"fake": True, "global_shape": dry["global_shape"],
                "mesh": dry["mesh"], "k": dry["k"],
                "variants": {tag: {key: rec[key] for key in keep}
                             for tag, rec in dry["variants"].items()}}
        print(json.dumps({"svd_dryrun": line}))
        summary["examples_s"] = {n: secs[n] for n in EXAMPLES}
        if step_s is not None:
            rec = dry["variants"]["block/opt"]
            rows, n = rec["per_rank_shape"]
            node_bytes = rec["a_bytes"] * (M // rows) * (N // n)
            bound_s = node_bytes / PEAK_BYTES
            print(f"13.3 block/opt reads {node_bytes} bytes of A a step on "
                  f"the {M}x{N} per-node shard: {bound_s * 1e3:.2f} ms at "
                  f"{PEAK_BYTES:.3g} B/s; phase 3's fp32 solve took "
                  f"{step_s * 1e3:.2f} ms a step: "
                  f"{100 * bound_s / step_s:.1f} % of the byte bound")
            summary["byte_bound_share"] = bound_s / step_s
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    return summary


# ---------------------------------------------------------------------------
# phase 14: the LM families beyond the dense text models, served at full
# width: RG-LRU and RWKV-6 on their recurrence kernels, the capacity MoE,
# the VLM and audio front ends
# ---------------------------------------------------------------------------

LF_SEED = SEED + 40
LF_BATCH = 2
# (arch, layers kept (None: all), prompt tokens, decode steps); grok-1 is
# cut to 4 of its 64 layers (all need ~620 GB), llava-next to 16 of 60
LF_MODELS = (("recurrentgemma-9b", None, 4096, 16),
             ("rwkv6-1.6b", None, 4096, 16),
             ("grok-1-314b", 4, 2048, 8),
             ("llava-next-34b", 16, 1024, 8),
             ("musicgen-large", None, 1024, 16))
# their smoke configs, card against CPU (fp32, TOL_CACHE); llama4-scout's
# MoE too, which no full-width run takes
LF_SMOKE = ("recurrentgemma-9b", "rwkv6-1.6b", "grok-1-314b",
            "llama4-scout-17b-a16e", "llava-next-34b", "musicgen-large")
# the recurrences against their plain loops: max |kernel - plain| over the
# output's max |value|.  RG-LRU rounds each product and sum as the plain
# version does (bitwise in practice); RWKV-6's output sums its hd products
# in another order than the plain version's einsum
TOL_REC = {"rglru_scan": 1e-5, "wkv6": 1e-4}
REC_PATH = {"rglru_scan": (2, 4096, 4096), "wkv6": (2, 4096, 32, 64)}
# ragged shapes: T = 1, T no multiple of a stage (rglru_scan: 32 steps) or
# at a chunk's edges (wkv6: T = C - 1, C, C + 1 at each head size, added by
# rec_ragged), R no multiple of 4 or of a block's 64 channels
REC_RAGGED = {"rglru_scan": [(2, 1, 4096), (2, 4097, 256), (1, 33, 4096),
                             (3, 130, 100), (2, 161, 4099), (1, 95, 130)],
              "wkv6": [(2, 1, 32, 64), (2, 4097, 4, 64), (1, 33, 32, 64),
                       (3, 70, 5, 16), (2, 40, 3, 32), (1, 20, 2, 128)]}
# wkv6's decays at the edges the plain loop takes, at each head size: all
# below 1e-30 (exp(-80) and less, some subnormal) and all 1 - 2^-24
REC_DECAYS = {"strong": [(2, 69, 2, hd) for hd in (16, 32, 64, 128)],
              "near_one": [(2, 69, 2, hd) for hd in (16, 32, 64, 128)]}
REC_SOURCES = {"rglru_scan": "src/repro_torch/csrc/rglru_scan.cu",
               "wkv6": "src/repro_torch/csrc/wkv6.cu"}
# no Pallas kernel: the JAX package's scans, compiled by XLA
REC_REPLACES = {"rglru_scan": "src/repro/models/recurrent.py:65",
                "wkv6": "src/repro/models/recurrent.py:177"}
# local_attention at the families' head layouts, bf16 (B, H, Hkv, S, D,
# window, softcap): recurrentgemma's local layers (MQA, a group of 16 at
# D 256), grok-1's capped global layers, llava-next's group of 7,
# musicgen's group of 1 at D 64
LF_ATTN = (("recurrentgemma-9b local", 2, 16, 1, 4096, 256, 2048, None),
           ("grok-1-314b global", 2, 48, 8, 2048, 128, 2048, 30.0),
           ("llava-next-34b global", 2, 56, 8, 1600, 128, 1600, None),
           ("musicgen-large global", 2, 32, 32, 1024, 64, 1024, None))


def rec_inputs(torch, name, shape, g, dev, with_state, decay=None):
    """A recurrence's operands at ``shape``: decays in (0, 1) as the
    blocks make them, or wkv6's at one edge (``REC_DECAYS``)."""
    if name == "rglru_scan":
        a = torch.rand(shape, generator=g, device=dev) * 0.5 + 0.499
        b = torch.randn(shape, generator=g, device=dev)
        h0 = (torch.randn((shape[0], shape[2]), generator=g, device=dev)
              if with_state else None)
        return a, b, h0
    B, T, H, hd = shape
    r, k, v = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(shape, generator=g, device=dev)
                             * 0.5 - 2.0))
    if decay == "strong":
        w = torch.exp(-80.0 - 10.0 * torch.rand(shape, generator=g,
                                                device=dev))
    elif decay == "near_one":
        w = torch.full(shape, 1.0 - 2.0 ** -24, device=dev)
    u = torch.randn((H, hd), generator=g, device=dev) * 0.1
    S0 = (torch.randn((B, H, hd, hd), generator=g, device=dev)
          if with_state else None)
    return r, k, v, w, u, S0


def rec_bound(name, shape) -> tuple:
    """Least time on an H100 SXM: each input read once and each output
    written once (fp32) over the memory rate, against the fp32 flop over
    the fp32 (non-tensor) peak: RG-LRU 2 an element; RWKV-6 5 per (i, j)
    of a step (the output's and the state's multiply-adds, the outer
    product)."""
    if name == "rglru_scan":
        B, T, R = shape
        nbytes, flop = 4 * (3 * B * T * R + B * R), 2 * B * T * R
    else:
        B, T, H, hd = shape
        nbytes = 4 * (5 * B * T * H * hd + 2 * B * H * hd * hd + H * hd)
        flop = 5 * B * T * H * hd * hd
    return pick(nbytes / PEAK_BYTES * 1e3, flop / PEAK_OPS["float32"] * 1e3)


def rec_reading(torch, name, got, want) -> tuple:
    """(max |kernel - plain|, its share of ``TOL_REC`` relative to the
    output's max |value|, the state bitwise equal) of one call."""
    outs = (got,) if name == "rglru_scan" else got
    wants = (want,) if name == "rglru_scan" else want
    mae = max(float((a - b).abs().max()) for a, b in zip(outs, wants))
    share = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(outs, wants)) / TOL_REC[name]
    return mae, share, torch.equal(outs[-1], wants[-1])


def rec_rerun(torch, name, kern, x, got) -> bool:
    """Whether a second call on the same inputs gives the same bits."""
    again = kern(*x)
    outs = (got,) if name == "rglru_scan" else got
    agains = (again,) if name == "rglru_scan" else again
    return all(torch.equal(a, b) for a, b in zip(outs, agains))


def rec_ragged(name) -> list:
    """``REC_RAGGED[name]``; for wkv6 also T = C - 1, C, C + 1 at each head
    size, C the steps a chunk that the build reports
    (``recurrent.wkv_chunk``)."""
    if name != "wkv6":
        return REC_RAGGED[name]
    from repro_torch.kernels import recurrent as rec
    return REC_RAGGED[name] + [(2, rec.wkv_chunk(hd) + d, 3, hd)
                               for hd in rec.WKV_HEAD_DIMS
                               for d in (-1, 0, 1)]


def rec_bwd_ragged() -> list:
    """wkv6's backward shapes: ``rec_ragged("wkv6")``, T = U - 1, U, U + 1
    at each head size (U the steps a sub-chunk of the backward that the
    build reports, ``recurrent.wkv_bwd_sub``), and one block (hd 64) and
    two (hd 128, its two partials) on the card."""
    from repro_torch.kernels import recurrent as rec
    return rec_ragged("wkv6") + [(2, rec.wkv_bwd_sub(hd) + d, 3, hd)
                                 for hd in rec.WKV_HEAD_DIMS
                                 for d in (-1, 0, 1)] + [
        (1, 77, 1, 64), (1, 45, 1, 128)]


def recurrence_checks(torch, ops, ref, dev) -> dict:
    """Both recurrences against their plain loops at ragged shapes (T = 1,
    T at and past a chunk's edges, B = 1, R ragged, with and without an
    initial state; wkv6 also at its decays' edges), then at the prefill's
    shapes, timed beside their bounds and plain versions; each call one
    launch, its state bitwise the plain loop's and its rerun bitwise its
    own.  Returns each kernel's row."""
    g = torch.Generator(device=dev).manual_seed(LF_SEED + 1)
    kern = {"rglru_scan": ops.rglru_scan, "wkv6": ops.wkv6}
    plain = {"rglru_scan": ref.rglru_scan_ref, "wkv6": ref.wkv6_ref}
    rows = {}
    for name in ("rglru_scan", "wkv6"):
        cases = [(shape, with_state, None) for shape in rec_ragged(name)
                 for with_state in (False, True)]
        if name == "wkv6":
            cases += [(shape, True, decay) for decay, shapes in
                      REC_DECAYS.items() for shape in shapes]
        for shape, with_state, decay in cases:
            x = rec_inputs(torch, name, shape, g, dev, with_state, decay)
            ops.reset_launches()
            got = kern[name](*x)
            torch.cuda.synchronize()
            if ops.launches[name] != 1:
                fail(f"{name} {shape}: launches {ops.launches[name]}")
            mae, share, same = rec_reading(torch, name, got,
                                           plain[name](*x))
            rerun = rec_rerun(torch, name, kern[name], x, got)
            print(f"  {name} {shape} state={with_state}"
                  + (f" decays={decay}" if decay else "")
                  + f": max abs err {mae:.2e}, {share:.3f} of the limit "
                  f"({TOL_REC[name]:.0e} of max |out|), state bitwise "
                  f"equal: {same}, rerun bitwise: {rerun}")
            if not (share <= 1 and same and rerun):
                fail(f"{name} {shape} decays={decay}: {share} of the "
                     f"limit, state bitwise {same}, rerun bitwise {rerun}")
        shape = REC_PATH[name]
        x = rec_inputs(torch, name, shape, g, dev, True)
        got = kern[name](*x)
        mae, share, same = rec_reading(torch, name, got, plain[name](*x))
        rerun = rec_rerun(torch, name, kern[name], x, got)
        del got
        if not (share <= 1 and same and rerun):
            fail(f"{name} {shape}: {share} of the limit, state bitwise "
                 f"{same}, rerun bitwise {rerun}")
        row = {"max_abs_err": mae, "share_of_limit": share,
               "state_bitwise": same, "rerun_bitwise": rerun,
               "ms": time_ms(torch, lambda: kern[name](*x), 20),
               "plain_ms": time_ms(torch, lambda: plain[name](*x), 1),
               "library_ms": None}
        row["bound_ms"], row["bound_by"] = rec_bound(name, shape)
        print(f"  {name} at the prefill's {shape}: max abs err {mae:.2e} "
              f"({share:.3f} of the limit), state bitwise equal {same}, "
              f"rerun bitwise {rerun}; "
              f"kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.1f} ms, "
              f"bound {row['bound_ms']:.3f} ms ({row['bound_by']}, "
              f"{100 * row['bound_ms'] / row['ms']:.1f} % of it); library - "
              f"(no PyTorch call computes it)")
        rows[name] = row
        del x
    torch.cuda.empty_cache()
    return rows


def family_attention(torch, ops, ref, la, dev) -> dict:
    """``local_attention`` at the families' head layouts against its plain
    version (per element, phase 7's rule), timed beside its bound, the
    plain version and ``scaled_dot_product_attention`` on the same
    inputs, K and V repeated
    to the query heads as phase 7 does: a band mask where the window is
    shorter than the sequence, ``is_causal=True`` where it is not; none
    on a capped layer (no call soft-caps)."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(LF_SEED + 2)
    rows = {}
    for label, B, H, Hkv, S, D, window, cap in LF_ATTN:
        q, k, v = attn_inputs(torch, g, dev, B, H, Hkv, S, D, torch.bfloat16)
        got = ops.local_attention(q, k, v, window=window, softcap=cap)
        torch.cuda.synchronize()
        mae, (share,) = attn_readings(torch, ref, [got], q, k, v, window,
                                      cap)
        row = {"max_abs_err": mae, "share_of_limit": share,
               "route": la.route(q.dtype, D),
               "ms": time_ms(torch, lambda: ops.local_attention(
                   q, k, v, window=window, softcap=cap), 10),
               "plain_ms": time_ms(torch, lambda: plain_attention(
                   ref, q, k, v, window, cap), 1),
               "library_ms": None, "library_call": None}
        if cap is None:
            qc = q.contiguous()
            kr = k.repeat_interleave(H // Hkv, dim=1).contiguous()
            vr = v.repeat_interleave(H // Hkv, dim=1).contiguous()
            if window < S:
                pos = torch.arange(S, device=dev)
                band = (pos[None, :] <= pos[:, None]) & (
                    pos[None, :] > pos[:, None] - window)
                row["library_call"] = "band mask"
                row["library_ms"] = time_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        qc, kr, vr, attn_mask=band), 3)
                del band
            else:
                row["library_call"] = "is_causal"
                row["library_ms"] = time_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        qc, kr, vr, is_causal=True), 10)
            del qc, kr, vr
        row["bound_ms"], row["bound_by"] = attn_bound(B, H, Hkv, S, D,
                                                      window)
        lib = ("- (no call soft-caps)" if row["library_ms"] is None
               else f"{row['library_ms']:.3f} ms ({row['library_call']}, "
               f"K/V repeated)")
        print(f"  local_attention bf16 {label} ({row['route']}) B={B} H={H} "
              f"Hkv={Hkv} S={S} D={D} window={window} softcap={cap}: max "
              f"abs err {mae:.2e}, {share:.2f} of the per-element limit, "
              f"kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.2f} ms, "
              f"bound {row['bound_ms']:.3f} ms ({row['bound_by']}); "
              f"scaled_dot_product_attention {lib}")
        if not (bool(torch.isfinite(got).all()) and share <= 1):
            fail(f"local_attention {label}: {share} of the limit")
        rows[label] = row
        del q, k, v, got
    torch.cuda.empty_cache()
    return rows


def family_smoke_serve(torch, T, serve, model, dev, tokens, patches) -> tuple:
    """``model`` on ``dev``: a prefill of ``tokens[..., :CACHE_PROMPT]``
    (the VLM's ``patches`` first), then ``CACHE_STEPS`` decode steps fed
    the next columns; (each step's logits, the final cache) on the CPU."""
    P = CACHE_PROMPT
    logits, cache, _ = serve.serve_prefill(
        model, tokens[..., :P].to(dev), P + CACHE_STEPS,
        patch_embeds=None if patches is None else patches.to(dev))
    out = [logits.cpu()]
    start = serve.decode_start(model.cfg, P)
    for i in range(CACHE_STEPS):
        logits, cache = T.decode_step(
            model, cache, tokens[..., P + i:P + i + 1].to(dev), start + i)
        out.append(logits.cpu())
    return out, [{n: t.cpu() for n, t in c.items()} for c in cache]


def family_smoke_checks(torch, T, serve, dev) -> dict:
    """Each family's fp32 smoke config served on the card and on the CPU
    from the same seed-0 weights (drawn on the CPU, copied to the card),
    the decode fed the CPU's greedy tokens: every step's logits and every
    cache tensor within ``TOL_CACHE``, the slots' positions equal."""
    import copy
    cpu = torch.device("cpu")
    out = {}
    for arch in LF_SMOKE:
        model = serve.build(arch, smoke=True, device=cpu, seed=LF_SEED)
        cfg = model.cfg
        prompt = serve.make_prompt(cfg, LF_BATCH, CACHE_PROMPT, seed=LF_SEED,
                                   device=cpu)
        patches = (torch.randn((LF_BATCH, cfg.patch_positions, cfg.d_model),
                               generator=torch.Generator().manual_seed(
                                   LF_SEED))
                   if cfg.family == "vlm" else None)
        logits, cache, _ = serve.serve_prefill(
            model, prompt, CACHE_PROMPT + CACHE_STEPS, patch_embeds=patches)
        fed, _, _ = serve.serve_decode(model, cache, logits,
                                       serve.decode_start(cfg, CACHE_PROMPT),
                                       CACHE_STEPS)
        tokens = torch.cat([prompt, fed], dim=-1)
        want = family_smoke_serve(torch, T, serve, model, cpu, tokens,
                                  patches)
        card = copy.deepcopy(model).to(dev)
        err, same = cache_reading(torch, family_smoke_serve(
            torch, T, serve, card, dev, tokens, patches), want)
        print(f"  {cfg.name} fp32, card vs CPU, prefill {CACHE_PROMPT} + "
              f"{CACHE_STEPS} decode steps: worst rel err over the logits "
              f"and cache tensors {err:.2e} (limit {TOL_CACHE:.0e}), slot "
              f"positions equal: {same}")
        if not (same and err <= TOL_CACHE):
            fail(f"{cfg.name} card vs CPU: {err} (limit {TOL_CACHE}), "
                 f"positions equal {same}")
        out[arch] = err
        del model, card
    torch.cuda.empty_cache()
    return out


def expected_launches(cfg) -> tuple:
    """(a prefill's, a decode step's) kernel launches: one attention an
    attention layer in the prefill, one recurrence a recurrent layer in
    both."""
    per = {"local_attention": sum(k in ("attn", "local") for k in cfg.blocks),
           "rglru_scan": cfg.blocks.count("rglru"),
           "wkv6": cfg.blocks.count("rwkv")}
    pre = {n: c for n, c in per.items() if c}
    return pre, {n: c for n, c in pre.items() if n != "local_attention"}


def count_drops(M, drops: list):
    """Wrap ``mlp.moe_route`` to keep each call's dropped (token, choice)
    count (a device scalar: no sync); returns the original."""
    route = M.moe_route

    def counting(p, cfg, x):
        out = route(p, cfg, x)
        drops.append((~out["keep"]).sum())
        return out
    M.moe_route = counting
    return route


def serve_family(torch, ops, T, M, serve, dev, cfg, S, steps,
                 profile=False) -> dict:
    """One family at full width: build, a prefill of ``LF_BATCH`` x ``S``
    seeded tokens, ``steps`` greedy decode steps (launches, finite logits,
    tokens in range, seconds, peak memory), decode at position S against
    a prefill over S + 1 (the MoE on a copy of its config with capacity
    factor E / k, where no token can drop; the drops at the published
    factor printed), and, with ``profile``, where a prefill's device time
    goes."""
    import dataclasses
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = T.init_model(cfg, seed=LF_SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"{cfg.name}: {cfg.num_layers} layers ({', '.join(f'{cfg.blocks.count(k)} {k}' for k in dict.fromkeys(cfg.blocks))}), "
          f"{n_params / 1e9:.3f} B parameters ({w_bytes / 1e9:.2f} GB "
          f"{cfg.dtype}) drawn on the card from seed {LF_SEED} in "
          f"{time.perf_counter() - t0:.1f} s")
    prompt = serve.make_prompt(cfg, LF_BATCH, S, seed=LF_SEED, device=dev)
    want_pre, want_step = expected_launches(cfg)
    drops = []
    route = count_drops(M, drops) if cfg.is_moe else None
    try:
        ops.reset_launches()
        logits, cache, t_pre = serve.serve_prefill(model, prompt, S + steps)
        pre = {n: c for n, c in ops.launches.items() if c}
    finally:
        if route is not None:
            M.moe_route = route
    dropped = int(sum(drops)) if drops else 0
    start = serve.decode_start(cfg, S)
    ops.reset_launches()
    tokens, last, t_dec = serve.serve_decode(model, cache, logits, start,
                                             steps)
    dec = {n: c for n, c in ops.launches.items() if c}
    peak = torch.cuda.max_memory_allocated()
    V = cfg.vocab_size
    row = {"layers": cfg.num_layers, "params": n_params,
           "prompt": S, "steps": steps, "prefill_s": t_pre,
           "decode_ms_a_step": 1e3 * t_dec / steps,
           "weight_read_ms": w_bytes / PEAK_BYTES * 1e3,
           "peak_gib": peak / 2**30, "prefill_launches": pre,
           "decode_launches": dec}
    print(f"serve {cfg.name} batch {LF_BATCH}: prefill {S} tokens"
          + (f" (+ {serve.patch_positions(cfg)} patch positions)"
             if serve.patch_positions(cfg) else "")
          + f" {t_pre:.3f} s ({LF_BATCH * S / t_pre:.0f} tokens/s), launches "
          f"{pre}; {steps} greedy decode steps {t_dec:.3f} s "
          f"({1e3 * t_dec / steps:.2f} ms a step; weight-read bound "
          f"{row['weight_read_ms']:.2f} ms), launches {dec}; peak device "
          f"memory {peak / 2**30:.1f} GiB")
    if cfg.is_moe:
        T_k = LF_BATCH * S * cfg.experts_per_token
        print(f"  {cfg.name} at capacity factor {cfg.capacity_factor}: "
              f"{dropped} of {T_k} (token, choice) pairs dropped over the "
              f"prefill's {cfg.num_layers} MoE layers ({100 * dropped / (T_k * cfg.num_layers):.2f} %)")
        row["dropped"] = dropped
    if pre != want_pre:
        fail(f"{cfg.name} prefill launches {pre}, want {want_pre}")
    want_dec = {n: c * steps for n, c in want_step.items()}
    if dec != want_dec:
        fail(f"{cfg.name} decode launches {dec}, want {want_dec}")
    shape = ((LF_BATCH, cfg.num_codebooks, steps) if cfg.family == "audio"
             else (LF_BATCH, steps))
    if not (tuple(tokens.shape) == shape and int(tokens.min()) >= 0
            and int(tokens.max()) < V and bool(torch.isfinite(logits).all())
            and bool(torch.isfinite(last).all())
            and logits.shape[-1] == V):
        fail(f"{cfg.name}: non-finite logits or tokens out of range")
    print(f"  seq0: {tokens[0].reshape(-1, steps)[0, :16].tolist()}")
    del cache, last

    if cfg.is_moe:        # C = T: no token can drop in either run
        model.cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    again, cache, _ = serve.serve_prefill(model, prompt, S + 3)
    nxt = torch.argmax(again, dim=-1)[..., None]
    dec_logits, _ = T.decode_step(model, cache, nxt, start)
    del cache
    P = serve.patch_positions(cfg)
    patches = (torch.zeros((LF_BATCH, P, cfg.d_model), device=dev)
               if P else None)
    full, _ = T.prefill(model, torch.cat([prompt, nxt], dim=-1), None,
                        patch_embeds=patches)
    e = rel_err(torch, dec_logits, full)
    row["decode_vs_prefill"] = e
    print(f"  decode at position {start} vs prefill over {start + 1} "
          f"positions" + (f" (capacity factor {model.cfg.capacity_factor})"
                          if cfg.is_moe else "")
          + f": rel err {e:.2e} (limit {TOL_CONSISTENCY:.0e})")
    if not (bool(torch.isfinite(dec_logits).all()) and e <= TOL_CONSISTENCY):
        fail(f"{cfg.name} decode vs prefill: rel err {e}")
    model.cfg = cfg
    del dec_logits, full, again

    if profile:
        _, wall, busy, n_act, names = profile_window(
            torch, lambda: T.prefill(model, prompt, None)[0])
        if n_act:
            top = sorted(names.items(), key=lambda x: -x[1])
            rec = sum(t for n_, t in names.items()
                      if "rglru_scan" in n_ or "wkv6" in n_)
            attn = sum(t for n_, t in names.items() if "local_attn" in n_)
            row["profile"] = {"wall_s": wall, "busy_s": busy,
                              "recurrence_s": rec, "attention_s": attn,
                              "activities": n_act}
            print(f"  profile of a prefill: {wall:.3f} s under the profiler, "
                  f"device busy {busy:.3f} s ({100 * busy / wall:.1f} %), "
                  f"{n_act} device activities; the recurrence kernels "
                  f"{rec:.3f} s ({100 * rec / busy:.1f} % of busy), "
                  f"local_attention {attn:.3f} s ({100 * attn / busy:.1f} "
                  f"%); by time: " + ", ".join(
                      f"{n_[:40]} {t:.3f} s" for n_, t in top[:6]))
        else:
            print("  profile: not measured (the profiler saw no device "
                  "activity)")
    del model
    torch.cuda.empty_cache()
    return row


def lm_families(torch, ops, ref, la, dev) -> tuple:
    """Phase 14; returns (its summary, the recurrences' kernel rows with
    their launches on the served path)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import mlp as M
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    rows = recurrence_checks(torch, ops, ref, dev)
    summary = {"attention": family_attention(torch, ops, ref, la, dev),
               "smoke_card_vs_cpu": family_smoke_checks(torch, T, serve,
                                                        dev),
               "models": {}}
    launches = {"rglru_scan": 0, "wkv6": 0}
    for arch, layers, S, steps in LF_MODELS:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        row = serve_family(torch, ops, T, M, serve, dev, cfg, S, steps,
                           profile=arch in ("recurrentgemma-9b",
                                            "rwkv6-1.6b"))
        summary["models"][arch] = row
        for name in launches:
            launches[name] += (row["prefill_launches"].get(name, 0)
                               + row["decode_launches"].get(name, 0))
    line = [{"name": name, "route": "cuda", "source": REC_SOURCES[name],
             "replaces": REC_REPLACES[name], "launches": launches[name],
             **{key: rows[name][key] for key in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")},
             "share_of_bound": rows[name]["bound_ms"] / rows[name]["ms"]}
            for name in ("rglru_scan", "wkv6")]
    summary["kernels"] = rows
    summary["seconds"] = time.perf_counter() - t_phase
    print(f"phase 14: {summary['seconds']:.1f} s")
    return summary, line


# ---------------------------------------------------------------------------
# phase 15: training of the recurrent families on the card: the backward
# kernels of rglru_scan and wkv6, rwkv6-1.6b and recurrentgemma-9b at full
# width, every family's smoke config card against CPU
# ---------------------------------------------------------------------------

RT_SEED = SEED + 50
# the backward kernels at a training step's shapes (8 x 2048 tokens; no
# initial state and an unused last state, as a training step has them)
REC_TRAIN = {"rglru_scan_bwd": (TR_BATCH, TR_SEQ, 4096),
             "wkv6_bwd": (TR_BATCH, TR_SEQ, 32, 64)}
# wkv6's gradients other than dS0 (sums over a key or a value index in
# another order than the plain loop's), each against its largest
# magnitude: the forward output's limit; RG-LRU's da, db, dh0 and
# wkv6's dS0 are held bitwise
TOL_WKV6_BWD = 1e-4
# (arch, layers kept (None: all)): recurrentgemma-9b is cut to 6 of its 38
# layers, two (rglru, rglru, local) groups: ~2.4e9 parameters with the
# 256000 x 4096 embedding, ~38 GB at 16 bytes a parameter (bf16 weight and
# gradient, fp32 moments and gradient sums); all 38 need ~144 GB
RT_MODELS = (("rwkv6-1.6b", None), ("recurrentgemma-9b", 6))
RT_STEPS, RT_COMP_STEPS = 5, 2
# compress_ratio of rwkv6-1.6b at full width, rank 8, min_size 65536 (the
# JAX package's count, tests/test_torch_recurrent_bwd.py): 14 compressed
# leaves of 19
RT_RATIO = 6335569920 / 24149248
RT_RERUN_LAYERS = 2                    # the bitwise rerun's full-width depth
# recurrentgemma-9b's local layers at the training step's shape (B, H, Hkv,
# S, D, window, softcap): MQA, a group of 16 at D 256, window 2048
RT_ATTN = (TR_BATCH, 16, 1, TR_SEQ, 256, 2048, None)


def rec_bwd_bound(name, shape, with_state=False, with_ds=False) -> tuple:
    """Least time of a backward on an H100 SXM: each input read once and
    each output written once (fp32) over the memory rate, against its
    fp32 flop over the fp32 peak.  RG-LRU: g, a, h read, da, db written
    (and h0 read, dh0 written with a state); 3 flop an element.  RWKV-6:
    r, k, v, w, do read, dr, dk, dv, dw written, u and du, dS0 written,
    dS_T read where given, the chunk starts read; 14 flop per (i, j) of a
    step (S recomputed: 3; D updated: 3; the four sums' multiply-adds: 8)
    and 5 per element for b_t and q_t."""
    if name == "rglru_scan_bwd":
        B, T, R = shape
        nbytes = 4 * (5 * B * T * R + 2 * B * R * with_state)
        return pick(nbytes / PEAK_BYTES * 1e3,
                    3 * B * T * R / PEAK_OPS["float32"] * 1e3)
    from repro_torch.kernels import recurrent as rec
    B, T, H, hd = shape
    chunks = -(-T // rec.wkv_chunk(hd))
    nbytes = 4 * (9 * B * T * H * hd + 2 * H * hd
                  + B * H * hd * hd * (1 + with_ds + chunks))
    flop = 14 * B * T * H * hd * hd + 5 * B * T * H * hd
    return pick(nbytes / PEAK_BYTES * 1e3, flop / PEAK_OPS["float32"] * 1e3)


def rec_bwd_case(torch, ops, ref, name, shape, g, dev, with_state,
                 with_ds=False, decay=None) -> tuple:
    """One draw of a backward against its plain reverse loop: (the
    kernel's operands, max |kernel - plain|, the worst share of
    ``TOL_WKV6_BWD`` (0 for RG-LRU, held bitwise), the bitwise outputs
    equal, a rerun bitwise).  Each call through ``ops`` launches the
    backward once; wkv6's chunk starts come from its forward kernel,
    called outside the count."""
    fwd = name[:-len("_bwd")]
    x = rec_inputs(torch, fwd, shape, g, dev, with_state, decay)
    if name == "rglru_scan_bwd":
        a, b, h0 = x
        args = (a, ops.rglru_scan(a, b, h0), h0,
                torch.randn(shape, generator=g, device=dev))
        kern, plain, exact = ops.rglru_scan_bwd, ref.rglru_scan_bwd_ref, (
            0, 1, 2)
        launched = {"rglru_scan_bwd": 1}
    else:
        B, T, H, hd = shape
        dS = (torch.randn((B, H, hd, hd), generator=g, device=dev)
              if with_ds else None)
        args = (*x, torch.randn(shape, generator=g, device=dev), dS)
        from repro_torch.kernels import recurrent as rec
        Sc = rec.wkv6_cuda(*x, states=True)[2]
        kern = lambda *a: ops.wkv6_bwd(*a, states=Sc)
        plain, exact = ref.wkv6_bwd_ref, (5,)
        launched = {"wkv6_bwd": 1}
    ops.reset_launches()
    got = kern(*args)
    torch.cuda.synchronize()
    if {n: c for n, c in ops.launches.items() if c} != launched:
        fail(f"{name} {shape}: launches {ops.launches}")
    want = plain(*args)
    again = kern(*args)
    mae, share, same, rerun = 0.0, 0.0, True, True
    for i, (a_, b_, c_) in enumerate(zip(got, want, again)):
        if b_ is None:
            same &= a_ is None and c_ is None
            continue
        err = float((a_ - b_).abs().max())
        mae = max(mae, err)
        rerun &= torch.equal(a_, c_)
        if i in exact:
            same &= torch.equal(a_, b_)
        else:
            share = max(share, err / (TOL_WKV6_BWD
                                      * max(float(b_.abs().max()), 1e-30)))
    return args, mae, share, same, rerun


def compressed_card_vs_cpu(torch, dev, archs) -> dict:
    """15.3, compressed: the smoke configs (fp32) of ``archs``,
    ``TR_CPU_STEPS`` compressed steps, each taken on the CPU and on the
    card from the CPU's state (copied onto the card before the step):
    the loss within ``TOL_TRAIN_CPU`` and each compressed leaf's
    decompressed gradient ``P Qn^T`` within ``TOL_TRAIN_CPU`` of the norm
    of what it compresses (``M``, the gradient plus the error buffer);
    the parameters after the step are printed beside, not held.  Not the
    12.4 trajectory: with the compression, AdamW's per-entry update turns
    rounding-sized differences of near-zero entries of ``P Qn^T`` into
    ``lr``-sized steps of single parameters, which then feed the next
    step; on the CPU alone a relative 1e-7 perturbation of the gradients
    moves rwkv6-1.6b's and grok-1's smoke parameters by more than 1e-3 of
    a tensor's norm over three steps
    (``tests/test_torch_recurrent_bwd.py``)."""
    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.models import convert as LV
    from repro_torch.optim import compression as comp
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training import (TrainConfig, init_train_state,
                                      make_train_step)
    log = []
    orig = comp.compress_grads

    def recording(grads, state, cc, layout, group=None):
        res = orig(grads, state, cc, layout, group)
        log.append({leaf.path: (
            (LV.gather(leaf, grads).float()
             + state["err"][leaf.path]).detach().cpu(),
            LV.gather(leaf, res[0]).float().detach().cpu())
            for leaf in layout if leaf.path in state["Q"]})
        return res
    out = {}
    comp.compress_grads = recording
    try:
        for arch in archs:
            cfg = configs.smoke_config(configs.get_config(arch))
            tc = TrainConfig(adamw=AdamWConfig(lr=TR_CPU_LR, warmup_steps=1,
                                               total_steps=TR_CPU_STEPS),
                             compression=comp.CompressionConfig(
                                 enabled=True, rank=TR_RANK, min_size=512))
            sc = init_train_state(cfg, tc, device="cpu")
            sg = init_train_state(cfg, tc, device=dev)
            ds = SyntheticLMDataset(DataConfig(
                cfg.vocab_size, 32, 4, family=cfg.family,
                num_codebooks=cfg.num_codebooks,
                patch_positions=cfg.patch_positions, d_model=cfg.d_model))
            step_c, step_g = (make_train_step(cfg, tc),
                              make_train_step(cfg, tc))
            row = {"loss_err": 0.0, "compressed_rel_err": 0.0,
                   "compressed_worst": "", "leaves": 0,
                   "param_rel_err": 0.0, "param_worst": ""}
            for i in range(TR_CPU_STEPS):
                sg.load_tree(tree_to(sc.tree(), dev))
                log.clear()
                sc, mc = step_c(sc, ds.batch(i))
                sg, mg = step_g(sg, ds.batch(i))
                lc, lg = log
                row["loss_err"] = max(row["loss_err"], abs(
                    float(mc["loss"]) - float(mg["loss"])))
                row["leaves"] = len(lc)
                for path, (M, hat) in lc.items():
                    e = float((lg[path][1] - hat).norm() / M.norm())
                    if e > row["compressed_rel_err"]:
                        row["compressed_rel_err"] = e
                        row["compressed_worst"] = path
                pc = dict(sc.model.named_parameters())
                for n, p in sg.model.named_parameters():
                    d = p.detach().cpu() - pc[n].detach()
                    r = float(d.norm() / pc[n].detach().norm())
                    if r > row["param_rel_err"]:
                        row["param_rel_err"], row["param_worst"] = r, n
            out[f"{arch} compressed"] = row
            print(f"  {cfg.name} fp32, {TR_CPU_STEPS} compressed steps at lr "
                  f"{TR_CPU_LR}, each from the CPU's state on the card and "
                  f"on the CPU: loss diff {row['loss_err']:.1e}, the "
                  f"{row['leaves']} compressed leaves' P Qn^T "
                  f"{row['compressed_rel_err']:.1e} of |M| "
                  f"({row['compressed_worst']}; limit {TOL_TRAIN_CPU:.0e} "
                  f"for both); parameters after a step "
                  f"{row['param_rel_err']:.1e} of their norm "
                  f"({row['param_worst']})")
            if not (row["loss_err"] <= TOL_TRAIN_CPU
                    and row["compressed_rel_err"] <= TOL_TRAIN_CPU
                    and row["leaves"] > 0):
                fail(f"{arch} compressed smoke: card vs CPU {row}")
    finally:
        comp.compress_grads = orig
    return out


def recurrence_bwd_checks(torch, ops, ref, dev) -> dict:
    """15.1: both backward kernels against their plain reverse loops at
    ragged shapes (``REC_RAGGED``, with and without an initial state and,
    wkv6, a given or an absent dS_T; wkv6 at ``REC_DECAYS``' edges too),
    then at a training step's shapes, timed beside their bounds and plain
    loops; wkv6's forward with and without the chunk starts timed there.
    Returns each kernel's row."""
    from repro_torch.kernels import recurrent as rec
    g = torch.Generator(device=dev).manual_seed(RT_SEED)
    rows = {}
    for name in ("rglru_scan_bwd", "wkv6_bwd"):
        fwd = name[:-len("_bwd")]
        combos = ((False, False), (True, True)) if fwd == "wkv6" else (
            (False, False), (True, False))
        cases = [(shape, st, ds, None)
                 for shape in (rec_bwd_ragged() if fwd == "wkv6"
                               else rec_ragged(fwd))
                 for st, ds in combos]
        if fwd == "wkv6":
            cases += [(shape, True, True, decay) for decay, shapes in
                      REC_DECAYS.items() for shape in shapes]
        worst = 0.0
        for shape, st, ds, decay in cases:
            _, mae, share, same, rerun = rec_bwd_case(
                torch, ops, ref, name, shape, g, dev, st, ds, decay)
            print(f"  {name} {shape} state={st}"
                  + (f" dS_T={ds}" if fwd == "wkv6" else "")
                  + (f" decays={decay}" if decay else "")
                  + f": max abs err {mae:.2e}, "
                  + (f"{share:.3f} of the limit ({TOL_WKV6_BWD:.0e} of each "
                     f"gradient's max |value|), dS0" if fwd == "wkv6"
                     else "da, db, dh0")
                  + f" bitwise equal: {same}, rerun bitwise: {rerun}")
            if not (share <= 1 and same and rerun):
                fail(f"{name} {shape} decays={decay}: {share} of the limit, "
                     f"bitwise {same}, rerun bitwise {rerun}")
            worst = max(worst, share)
        shape = REC_TRAIN[name]
        args, mae, share, same, rerun = rec_bwd_case(
            torch, ops, ref, name, shape, g, dev, False)
        if not (share <= 1 and same and rerun):
            fail(f"{name} {shape}: {share} of the limit, bitwise {same}, "
                 f"rerun bitwise {rerun}")
        if name == "rglru_scan_bwd":
            a, h, h0, dh = args
            kern = lambda: rec.rglru_scan_bwd_cuda(a, h, h0, dh)
            plain = lambda: ref.rglru_scan_bwd_ref(a, h, h0, dh)
        else:
            r, k, v, w, u, S0, do, dS = args
            Sc = rec.wkv6_cuda(r, k, v, w, u, S0, states=True)[2]
            kern = lambda: rec.wkv6_bwd_cuda(r, k, v, w, u, Sc, do, dS)
            plain = lambda: ref.wkv6_bwd_ref(r, k, v, w, u, S0, do, dS)
        row = {"max_abs_err": mae, "share_of_limit": share,
               "worst_ragged_share": worst, "bitwise": same,
               "rerun_bitwise": rerun, "shape": list(shape),
               "ms": time_ms(torch, kern, 20),
               "plain_ms": time_ms(torch, plain, 1), "library_ms": None}
        row["bound_ms"], row["bound_by"] = rec_bwd_bound(name, shape)
        if name == "wkv6_bwd":
            row["forward_ms"] = time_ms(
                torch, lambda: rec.wkv6_cuda(r, k, v, w, u, S0), 20)
            row["forward_states_ms"] = time_ms(
                torch, lambda: rec.wkv6_cuda(r, k, v, w, u, S0, states=True),
                20)
            del Sc, args, kern, plain
            row["by_head_size"] = wkv6_bwd_head_sizes(torch, rec, g, dev)
        print(f"  {name} at a training step's {shape}: max abs err "
              f"{mae:.2e}" + (f" ({share:.3f} of the limit)"
                              if name == "wkv6_bwd" else "")
              + f", bitwise {same}, rerun bitwise {rerun}; kernel "
              f"{row['ms']:.3f} ms, plain {row['plain_ms']:.1f} ms, bound "
              f"{row['bound_ms']:.3f} ms ({row['bound_by']}, "
              f"{100 * row['bound_ms'] / row['ms']:.1f} % of it); library - "
              f"(no PyTorch call computes it)"
              + (f"; the forward {row['forward_ms']:.3f} ms, with the chunk "
                 f"starts {row['forward_states_ms']:.3f} ms"
                 if name == "wkv6_bwd" else ""))
        rows[name] = row
        if name == "rglru_scan_bwd":
            del args, kern, plain
        torch.cuda.empty_cache()
    return rows


# wkv6_bwd at a training step's 8 x 2048 tokens at every head size: the
# same state elements a step as rwkv6-1.6b's 32 heads of 64, and twice as
# many at hd 128
WKV6_BWD_SHAPES = ((TR_BATCH, TR_SEQ, 128, 16), (TR_BATCH, TR_SEQ, 64, 32),
                   (TR_BATCH, TR_SEQ, 32, 64), (TR_BATCH, TR_SEQ, 16, 128))


def wkv6_bwd_head_sizes(torch, rec, g, dev) -> dict:
    """15.1: the wkv6 backward kernel at ``WKV6_BWD_SHAPES``, from its
    forward's chunk starts (no initial state, dS_T absent, as a training
    step has them): ms (CUDA events, 20 launches), bound, share of the
    bound, blocks an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    through ``recurrent.wkv_bwd_blocks_per_sm``) and a rerun bitwise."""
    out = {}
    for shape in WKV6_BWD_SHAPES:
        B, T, H, hd = shape
        r, k, v, w, u, _ = rec_inputs(torch, "wkv6", shape, g, dev, False)
        do = torch.randn(shape, generator=g, device=dev)
        Sc = rec.wkv6_cuda(r, k, v, w, u, None, states=True)[2]
        kern = lambda: rec.wkv6_bwd_cuda(r, k, v, w, u, Sc, do, None)
        first, again = kern(), kern()
        rerun = all(torch.equal(a, b) for a, b in zip(first, again))
        del first, again
        row = {"ms": time_ms(torch, kern, 20),
               "blocks_per_sm": rec.wkv_bwd_blocks_per_sm(hd),
               "rerun_bitwise": rerun}
        row["bound_ms"], row["bound_by"] = rec_bwd_bound("wkv6_bwd", shape)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        print(f"  wkv6_bwd {shape}: {row['ms']:.3f} ms, bound "
              f"{row['bound_ms']:.3f} ms ({row['bound_by']}), "
              f"{100 * row['share_of_bound']:.1f} % of it; "
              f"{row['blocks_per_sm']} blocks an SM; rerun bitwise {rerun}")
        if not rerun or row["blocks_per_sm"] < 1:
            fail(f"wkv6_bwd {shape}: rerun bitwise {rerun}, "
                 f"{row['blocks_per_sm']} blocks an SM")
        out[str(hd)] = row
        del r, k, v, w, u, do, Sc, kern
        torch.cuda.empty_cache()
    return out


def recurrent_attention_bwd(torch, ops, ref, la, dev) -> dict:
    """15.1: the attention backward at recurrentgemma-9b's local layers'
    training shape (``RT_ATTN``, bf16, the ``wgmma`` route): each element
    against the plain version with its sums in float64 (phase 7's rule;
    dK and dV sum 16 x 2048 terms, where the fp32 plain version's own
    rounding nears the rule's 1e-5 floor: its reading is printed beside),
    two runs bitwise, timed beside its bound."""
    B, H, Hkv, S, D, window, cap = RT_ATTN
    g = torch.Generator(device=dev).manual_seed(RT_SEED + 1)
    q, k, v = attn_inputs(torch, g, dev, B, H, Hkv, S, D, torch.bfloat16)
    do = attn_inputs(torch, g, dev, B, H, Hkv, S, D, torch.bfloat16)[0]
    lse = torch.empty((B, H, S), device=dev)
    o = la.local_attention_cuda(q, k, v, window, cap, lse)
    call = lambda: ops.local_attention_bwd(q, k, v, o, do, lse,
                                           window=window, softcap=cap)
    ops.reset_launches()
    got = call()
    ran = {n: c for n, c in ops.route_launches.items() if c}
    same = all(torch.equal(a, b) for a, b in zip(got, call()))
    shares = {"float64": [0.0] * 3, "float32": [0.0] * 3}
    for b in range(B):
        sl = slice(b, b + 1)
        for sums, key in ((torch.float64, "float64"),
                          (torch.float32, "float32")):
            want = ref.local_attention_bwd_ref(
                q[sl], k[sl], v[sl], o[sl], do[sl], lse[sl], window=window,
                softcap=cap, sums=sums)
            for i, (a, w) in enumerate(zip(got, want)):
                shares[key][i] = max(shares[key][i],
                                     attn_share(a[sl], w, "bfloat16"))
            del want
    row = {"route_launches": ran, "reruns_bitwise": same,
           "shares_of_limit": shares["float64"],
           "shares_against_fp32_plain": shares["float32"],
           "max_abs_err": max(float((a.float() - w).abs().max())
                              for a, w in zip(got, ref.local_attention_bwd_ref(
                                  q, k, v, o, do, lse, window=window,
                                  softcap=cap))),
           "ms": time_ms(torch, call, 10),
           "plain_ms": time_ms(torch, lambda: ref.local_attention_bwd_ref(
               q, k, v, o, do, lse, window=window, softcap=cap), 1)}
    row["bound_ms"], row["bound_by"] = attn_bwd_bound(B, H, Hkv, S, D, window)
    # the yardstick: autograd of SDPA (causal, as the window covers S), K
    # and V repeated to every head
    row["library_ms"] = None
    if window >= S and cap is None:
        import torch.nn.functional as F
        qc = q.contiguous().requires_grad_()
        kr, vr = (x.repeat_interleave(H // Hkv, dim=1).contiguous()
                  .requires_grad_() for x in (k, v))
        out = F.scaled_dot_product_attention(qc, kr, vr, is_causal=True)
        doc = do.contiguous()
        row["library_ms"] = time_ms(torch, lambda: torch.autograd.grad(
            out, (qc, kr, vr), doc, retain_graph=True), 5)
        del qc, kr, vr, out, doc
    print(f"  local_attention_bwd at recurrentgemma-9b's training layout "
          f"{RT_ATTN} bf16 ({sorted(ran)}): dq, dk, dv "
          + ", ".join(f"{x:.2f}" for x in shares["float64"])
          + " of the per-element limit against the float64 plain version ("
          + ", ".join(f"{x:.2f}" for x in shares["float32"])
          + f" against the fp32 one), reruns bitwise {same}; kernel "
          f"{row['ms']:.3f} ms, plain {row['plain_ms']:.1f} ms, bound "
          f"{row['bound_ms']:.3f} ms ({row['bound_by']}), autograd of SDPA "
          f"is_causal " + ("-" if row["library_ms"] is None
                           else f"{row['library_ms']:.3f} ms"))
    if ran != {"local_attention_bwd/wgmma": la.BWD_KERNELS} or not same \
            or max(shares["float64"]) > 1:
        fail(f"local_attention_bwd at recurrentgemma's layout: {row}")
    del q, k, v, o, do, lse, got
    torch.cuda.empty_cache()
    return row


def train_rerun_bitwise(torch, dev, arch) -> dict:
    """15.2: a ``RT_RERUN_LAYERS``-layer full-width model stepped twice
    from the same state (``init_train_state`` of one seed): the same loss
    and the same bits in every parameter and moment."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compression import CompressionConfig
    from repro_torch.training import (TrainConfig, init_train_state,
                                      make_train_step)
    cfg = dataclasses.replace(configs.get_config(arch),
                              num_layers=RT_RERUN_LAYERS,
                              loss_chunks=TR_CHUNKS)
    tc = TrainConfig(adamw=AdamWConfig(lr=TR_LR, warmup_steps=1,
                                       total_steps=2),
                     compression=CompressionConfig(enabled=False))
    batch = SyntheticLMDataset(DataConfig(cfg.vocab_size, TR_SEQ,
                                          TR_BATCH)).batch(0)
    first = None
    for _ in range(2):
        state = init_train_state(cfg, tc, seed=RT_SEED, device=dev)
        state, m = make_train_step(cfg, tc)(state, batch)
        now = (float(m["loss"]), tree_leaves(tree_to(state.tree(), dev)))
        del state
        if first is None:
            first = now
    same = first[0] == now[0] and all(
        torch.equal(a, b) for a, b in zip(first[1], now[1]))
    out = {"layers": RT_RERUN_LAYERS, "blocks": list(cfg.blocks),
           "loss": now[0], "tensors": len(now[1]), "bitwise": same}
    print(f"  {arch} at full width, {RT_RERUN_LAYERS} layers "
          f"{list(cfg.blocks)}, one step twice from the same state: loss "
          f"{now[0]:.6f}, {len(now[1])} tensors, bitwise equal {same}")
    if not same:
        fail(f"{arch}: two steps from the same state differ")
    del first, now
    torch.cuda.empty_cache()
    return out


def recurrent_full_width(torch, ops, dev) -> dict:
    """15.2: rwkv6-1.6b (24 layers) and recurrentgemma-9b (6 of 38) at
    full width, bf16 parameters, fp32 moments, ``loss_chunks`` 8, 8 x
    2048 synthetic tokens a step, ``RT_STEPS`` plain steps through
    ``init_train_state`` and ``make_train_step`` (every step's launches
    the accounting, the loss falling) and one more under the profiler;
    two compressed steps of rwkv6-1.6b (``compress_ratio`` the JAX
    package's count); each family's bitwise rerun."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compression import CompressionConfig
    from repro_torch.training import TrainConfig
    out = {"runs": {}, "reruns": {}}
    for arch, layers in RT_MODELS:
        cfg = dataclasses.replace(configs.get_config(arch),
                                  loss_chunks=TR_CHUNKS)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        ds = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=TR_SEQ,
                                           global_batch=TR_BATCH))
        batches = [ds.batch(i) for i in range(RT_STEPS)]
        for label, enabled, n in (("plain", False, RT_STEPS),
                                  ("compressed", True, RT_COMP_STEPS)):
            if enabled and arch != "rwkv6-1.6b":
                continue
            tc = TrainConfig(adamw=AdamWConfig(lr=TR_LR, warmup_steps=2,
                                               total_steps=n),
                             compression=CompressionConfig(
                                 enabled=enabled, rank=TR_RANK))
            t0 = time.perf_counter()
            r = train_run(torch, ops, dev, cfg, tc, batches[:n],
                          profile=not enabled, first_again=enabled)
            later = sorted(r["ms_steps"][1:])
            ms = later[len(later) // 2]
            r.update(ms_step=ms, tokens_s=TR_BATCH * TR_SEQ / (ms / 1e3),
                     params=cfg.param_count(), layers=cfg.num_layers,
                     seconds=time.perf_counter() - t0)
            print(f"  {cfg.name} {label}: {cfg.num_layers} layers "
                  f"({r['params'] / 1e9:.3f}e9 parameters, "
                  f"{16 * r['params'] / 1e9:.1f} GB at 16 bytes each), "
                  f"{TR_BATCH} x {TR_SEQ} tokens a step, bf16 parameters, "
                  f"fp32 moments, loss_chunks {TR_CHUNKS}: loss "
                  + " ".join(f"{x:.4f}" for x in r["losses"])
                  + f"; {ms:.1f} ms a step (median of steps 2-{n}; the "
                  f"first {r['ms_steps'][0]:.0f} ms), {r['tokens_s']:.0f} "
                  f"tokens/s, peak {r['peak_gb']:.2f} GB; launches a step "
                  f"{ {k: c for k, c in r['launches_per_step'].items() if c} }")
            # the plain runs' loss falls from the first batch to the last;
            # the compressed run's two steps move the next batch's loss
            # less than the batches' losses differ (a five-step compressed
            # run from the same state, on the previous wkv6 backward, ended
            # above its start), so it is held on the first batch, before
            # and after its steps
            after = r.get("first_loss_after", r["losses"][-1])
            if not after < r["losses"][0]:
                fail(f"{arch} {label}: the loss did not fall: "
                     f"{r['losses']}" + (f", the first batch's after the "
                                         f"steps {after}" if enabled
                                         else ""))
            if enabled:
                ratio = r["compress_ratio"]
                print(f"  {cfg.name} compress_ratio {ratio} (the JAX "
                      f"package's count {RT_RATIO:.6f})")
                if ratio != float(torch.tensor(RT_RATIO,
                                               dtype=torch.float32)):
                    fail(f"compress_ratio {ratio}, want {RT_RATIO}")
            else:
                prof = r["profile"]
                print(f"  {cfg.name} one plain step under the profiler: "
                      f"{prof['wall_ms']:.0f} ms, device busy "
                      f"{prof['busy_share']:.1%}; the recurrences' backward "
                      f"kernels {prof['recurrence_bwd_share']:.1%} of the "
                      f"busy time (wkv6_bwd {prof['wkv6_bwd_share']:.1%}; "
                      f"{prof['recurrence_bwd_ms']}), their "
                      f"forwards {prof['recurrence_fwd_share']:.1%}, the "
                      f"attention backward {prof['attention_bwd_share']:.1%}"
                      f", forward {prof['attention_fwd_share']:.1%}; top "
                      f"kernels (ms) {prof['top_ms']}")
            if enabled:
                print(f"  {cfg.name} {label}: the first batch's loss "
                      f"{r['losses'][0]:.4f} before the steps, "
                      f"{after:.4f} after them")
            out["runs"][f"{arch} {label}"] = {key: r.get(key) for key in (
                "losses", "first_loss_after", "ms_step", "ms_steps",
                "tokens_s", "peak_gb",
                "launches", "launches_per_step", "compress_ratio", "params",
                "layers", "seconds", "profile")}
        del batches
    for arch, _ in RT_MODELS:
        out["reruns"][arch] = train_rerun_bitwise(torch, dev, arch)
    return out


def recurrent_training(torch, ops, ref, la, dev) -> tuple:
    """Phase 15; returns (its summary, the backward kernels' rows of the
    ``kernels`` line, launches from 15.2's training steps)."""
    t_phase = time.perf_counter()
    rows = recurrence_bwd_checks(torch, ops, ref, dev)
    attn = recurrent_attention_bwd(torch, ops, ref, la, dev)
    t_kernels = time.perf_counter() - t_phase
    full = recurrent_full_width(torch, ops, dev)
    t_full = time.perf_counter() - t_phase - t_kernels
    cpu = train_card_vs_cpu(torch, dev, TR_CPU_ARCHS[TR_CPU_DENSE:],
                            modes=(False,))
    cpu.update(compressed_card_vs_cpu(torch, dev,
                                      TR_CPU_ARCHS[TR_CPU_DENSE:]))
    launches = {name: sum(r["launches"].get(name, 0)
                          for key, r in full["runs"].items()
                          if name != "local_attention_bwd"
                          or key.startswith("recurrentgemma"))
                for name in ("rglru_scan_bwd", "wkv6_bwd",
                             "local_attention_bwd")}
    line = [{"name": name, "route": "cuda", "source": REC_SOURCES[fwd],
             "replaces": REC_REPLACES[fwd], "launches": launches[name],
             **{key: rows[name][key] for key in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")},
             "share_of_bound": rows[name]["bound_ms"] / rows[name]["ms"]}
            for name, fwd in (("rglru_scan_bwd", "rglru_scan"),
                              ("wkv6_bwd", "wkv6"))] + [
        {"name": "local_attention_bwd/wgmma[recurrentgemma-9b]",
         "route": "cuda", "source": BWD_SOURCE, "replaces": BWD_REPLACES,
         "launches": launches["local_attention_bwd"],
         **{key: attn[key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")}}]
    for k in line:
        if not k["launches"]:
            fail(f"{k['name']} was not launched by the training path")
    summary = {"kernels": rows, "attention_bwd": attn, "full_width": full,
               "card_vs_cpu": cpu, "kernel_checks_s": t_kernels,
               "full_width_s": t_full,
               "seconds": time.perf_counter() - t_phase}
    print(f"phase 15: {summary['seconds']:.1f} s (kernels {t_kernels:.1f}, "
          f"full width {t_full:.1f})")
    return summary, line


# ---------------------------------------------------------------------------
# 16. the sharded LM: FSDP x TP on four gloo ranks sharing the card
# ---------------------------------------------------------------------------

SL_ARCH = "qwen3-0.6b"
# cut for the script's time only (all 28 layers, ~9.6 GB with moments,
# fit four ranks): 4 layers and 3 steps took 64.1 s of phase 16 in a whole
# run of 1015.4 s (NVIDIA H100 80GB HBM3, 700 W), over the phase's 60 s
SL_LAYERS = 2            # of 28
SL_MESH = (2, 2)         # data x model
SL_BATCH, SL_SEQ, SL_CHUNKS, SL_STEPS = 8, 2048, 8, 2
SL_RANKS = 4
SL_TIMEOUT = 300         # seconds for the four ranks
SL_SMOKE_LR = TR_CPU_LR
TOL_SL_SMOKE = 1e-4      # 16.2: the sharded step vs the one-process one
# 16.1, bf16 at full width, the sharded step against the one-process step
# on the same weights and batch: partial sums rounded to bf16 before the
# tensor-parallel all-reduce, where one process rounds
# once (NVIDIA H100 80GB HBM3, 700 W; readings: loss 3.67e-6; the
# matrices 3.44e-3 of their norm, every parameter 2.94e-2: a norm scale,
# zero at init, whose whole value is three AdamW updates of about lr an
# entry, each entry's sign that of its gradient, which the other rounding
# flips where the gradient is smallest).  A gradient summed over the
# wrong ranks moves whole tensors, O(1) of their norm
TOL_SL_LOSS = 1e-4       # the first step's loss, relative
TOL_SL_MATRICES = 1e-2   # each parameter of 2+ dims after SL_STEPS steps
TOL_SL_PARAMS = 1e-1     # every parameter after SL_STEPS steps, of its norm


def sl_config(dataclasses, configs):
    return dataclasses.replace(configs.get_config(SL_ARCH),
                               num_layers=SL_LAYERS, loss_chunks=SL_CHUNKS)


def sl_train_config(AdamWConfig, TrainConfig):
    return TrainConfig(adamw=AdamWConfig(lr=TR_LR, warmup_steps=2,
                                         total_steps=SL_STEPS))


def sl_smoke(configs, AdamWConfig, TrainConfig, DataConfig,
             SyntheticLMDataset, arch) -> tuple:
    """16.2's config, train config and batch for ``arch``."""
    cfg = configs.smoke_config(configs.get_config(arch))
    tc = TrainConfig(adamw=AdamWConfig(lr=SL_SMOKE_LR, warmup_steps=1,
                                       total_steps=1))
    batch = SyntheticLMDataset(DataConfig(
        cfg.vocab_size, 32, 4, family=cfg.family,
        num_codebooks=cfg.num_codebooks, patch_positions=cfg.patch_positions,
        d_model=cfg.d_model)).batch(0)
    return cfg, tc, batch


def moe_by_shard(torch, M, n_data):
    """The MoE of one process as the sharded step computes it on a
    ``(n_data, model)`` mesh (``models/mlp.py``, the JAX package's
    ``_moe_local``): each data shard's rows routed and dispatched with
    its own capacity, the experts' output of shard ``d`` kept for its D
    slice ``d`` and each rank's tokens combining the ``(E, C, D)`` those
    slices make up; the aux loss the shards' mean."""
    def apply(p, cfg, x):
        B, S, D = x.shape
        E, k = cfg.num_experts, cfg.experts_per_token
        b, dl = B // n_data, D // n_data
        routes, ys = [], []
        for j in range(n_data):
            xj = x[j * b:(j + 1) * b]
            rt = M.moe_route(p, cfg, xj)
            xk = xj.reshape(b * S, D).repeat_interleave(k, dim=0)
            C = rt["C"]
            buf = xj.new_zeros((E * C, D)).index_add_(
                0, rt["slot"], torch.where(rt["keep"][:, None], xk, 0)
            ).view(E, C, D)
            h = M._act(cfg.mlp_act)(torch.bmm(buf, p.w_gate)) * \
                torch.bmm(buf, p.w_in)
            routes.append(rt)
            ys.append(torch.bmm(h, p.w_out))
        y = torch.cat([ys[j][..., j * dl:(j + 1) * dl]
                       for j in range(n_data)], dim=-1)
        outs = []
        for rt in routes:
            C, keep, slot = rt["C"], rt["keep"], rt["slot"]
            o = y.reshape(E * C, D)[slot] * (
                keep[:, None] * rt["gates"].reshape(b * S * k, 1))
            outs.append(o.view(b * S, k, D).sum(dim=1).view(b, S, D))
        aux = sum(rt["aux"] for rt in routes) / n_data
        return torch.cat(outs).to(x.dtype), aux
    return apply


def param_rel_errs(torch, got: dict, want: dict, matrices=False) -> tuple:
    """(largest ||got - want|| / ||want|| over the parameters, its name,
    the largest single entry's difference); ``matrices``: over those of
    two dims or more only."""
    rel, worst, entry = 0.0, "", 0.0
    for n, w in want.items():
        if matrices and w.ndim < 2:
            continue
        w = w.detach().to(torch.float32).cpu()
        d = got[n].to(torch.float32) - w
        r = float(d.norm() / max(float(w.norm()), 1e-30))
        if r > rel:
            rel, worst = r, n
        entry = max(entry, float(d.abs().max()))
    return rel, worst, entry


# 16.3: compressed training across ranks (optim/compression.py on the
# ranks' shards), held step by step against one process
SC_MESH = (2, 1, 2)      # pod x data x model: each pod its own gradient
SC_STEPS = 2             # there; one step on SL_MESH (no pod axis)
SC_MIN_SIZE = 65536
TOL_SC_LOSS = 1e-4       # each step's loss from the parent's state, relative
# one step from the parent's state, of ||M|| (NVIDIA H100 80GB HBM3,
# 700 W; readings 2.65e-3 / 1.41e-3 / 3.81e-3 and 1.02e-2 / 7.24e-3 /
# 1.00e-2 for the three steps): M_hat = P Qn^T (from the factors) and each
# pod's new error buffer, M - M_hat, which carries the bf16 gradients'
# rounding in other sum orders whole, where M_hat keeps only its rank-8
# projection.  A gradient summed over the wrong ranks, or not divided by
# the pods, moves them O(1)
TOL_SC_HAT = 1e-2
TOL_SC_ERR = 3e-2


def sc_train_config(AdamWConfig, TrainConfig, CompressionConfig):
    return TrainConfig(adamw=AdamWConfig(lr=TR_LR, warmup_steps=2,
                                         total_steps=SC_STEPS),
                       compression=CompressionConfig(
                           rank=TR_RANK, min_size=SC_MIN_SIZE))


class FactorTap:
    """Records ``optim/compression.py::_orthonormalize``'s calls during a
    step: a compressed leaf's ``orth(P)`` and then ``orth(Qn)``, so
    ``factors()`` gives each leaf's ``(P, Qn)`` in leaf order."""

    def __init__(self, comp):
        self.comp, self.orig, self.calls = comp, comp._orthonormalize, []

    def __enter__(self):
        def tap(x):
            y = self.orig(x)
            self.calls.append((x, y))
            return y
        self.comp._orthonormalize = tap
        return self

    def __exit__(self, *exc):
        self.comp._orthonormalize = self.orig

    def factors(self) -> list:
        return [(self.calls[2 * j][1], self.calls[2 * j + 1][0])
                for j in range(len(self.calls) // 2)]


def hat_err(torch, a: tuple, b: tuple) -> float:
    """``||Pa Qa^T - Pb Qb^T||_F`` from the factors alone (r x r products,
    float64): the decompressed gradients' difference, never formed."""
    (Pa, Qa), (Pb, Qb) = [(P.double(), Q.double().to(P.device))
                          for P, Q in (a, b)]
    Pb = Pb.to(Pa.device)
    Qb = Qb.to(Pa.device)
    g = lambda X, Y: X.mT @ Y
    s = (torch.sum(g(Pa, Pa) * g(Qa, Qa)) - 2 * torch.sum(g(Pa, Pb) *
                                                         g(Qa, Qb))
         + torch.sum(g(Pb, Pb) * g(Qb, Qb)))
    return float(s.clamp(min=0).sqrt())


def sc_pod_step(torch, ops, train, comp, opt, LV, tc, state, errs, batch,
                npods) -> tuple:
    """One step of the cross-pod mode in one process (the JAX package's
    ``per_pod``, ``train.py:183-203``): each pod's gradient of its own
    rows, then for each compressed leaf ``P = orth(mean_p M_p Q)``, ``Qn
    = mean_p M_p^T P``, ``M_hat = P Qn^T``, ``err_p = M_p - M_hat``, ``Q
    = orth(Qn)``; the other leaves' pod mean; AdamW on the whole model.
    ``errs``: one dict of error buffers a pod, updated in place.  Returns
    (the loss, each compressed leaf's (P, Qn), ``{path: [||M_p||]}``)."""
    model = state.model
    dev = next(model.parameters()).device
    layout = LV.leaf_layout(model)
    rows = next(iter(batch.values())).shape[0] // npods
    pods = [train._grads_and_metrics(model, train.to_device(
        {k: v[p * rows:(p + 1) * rows] for k, v in batch.items()}, dev), 1)
        for p in range(npods)]
    mean = lambda xs: sum(xs[1:], xs[0]) / npods
    grads, factors, norms = {}, [], {}
    with torch.no_grad():
        for leaf in layout:
            gs = [LV.gather(leaf, g) for g, _ in pods]
            if leaf.path not in state.comp["Q"]:
                grads.update(LV.scatter(leaf, mean(gs)))
                continue
            ms = comp._mat_shape(leaf.shape)
            Ms = [g.to(torch.float32).reshape(ms) + e[leaf.path].reshape(ms)
                  for g, e in zip(gs, errs)]
            Q = state.comp["Q"][leaf.path]
            P = comp._orthonormalize(mean([ops.block_matvec(M, Q)
                                           for M in Ms]))
            Qn = mean([ops.block_rmatvec(M, P) for M in Ms])
            M_hat = P @ Qn.mT
            for e, M in zip(errs, Ms):
                e[leaf.path] = (M - M_hat).reshape(leaf.shape)
            grads.update(LV.scatter(leaf, M_hat.reshape(leaf.shape).to(
                gs[0].dtype)))
            state.comp["Q"][leaf.path] = comp._orthonormalize(Qn)
            factors.append((P, Qn))
            norms[leaf.path] = [float(M.norm()) for M in Ms]
            del Ms, M_hat
        opt.apply_updates(dict(model.named_parameters()), grads, state.opt,
                          tc.adamw, LV.decayed(layout))
    state.step += 1
    return float(sum(m["loss"] for _, m in pods)) / npods, factors, norms


def sc_references(torch, ops, dev, outdir) -> dict:
    """16.3's one-process references on the card, written into
    ``outdir`` for the ranks: the cross-pod mode's ``SC_STEPS`` steps
    (``sc_b<i>.pt``: loss, factors, ``||M_p||``, the new ``Q`` and the
    pods' error buffers; ``sc_state_b<i>.pt``: the rest of the state the
    ranks' step ``i + 1`` starts from) and the no-pod mode's one step
    (``sc_a1.pt``: the one-process compressed step)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.models import convert as LV
    from repro_torch.optim import adamw as opt
    from repro_torch.optim import compression as comp
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compression import CompressionConfig
    from repro_torch.training import (TrainConfig, init_train_state,
                                      make_train_step, train)
    cfg = sl_config(dataclasses, configs)
    tc = sc_train_config(AdamWConfig, TrainConfig, CompressionConfig)
    ds = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=SL_SEQ, global_batch=SL_BATCH))
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}
    out = {"b": [], "a": []}
    state = init_train_state(cfg, tc, device=dev)
    errs = [dict(state.comp["err"]) for _ in range(SC_MESH[0])]
    for i in range(SC_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with FactorTap(comp):
            loss, factors, norms = sc_pod_step(
                torch, ops, train, comp, opt, LV, tc, state, errs,
                ds.batch(i), SC_MESH[0])
        torch.cuda.synchronize()
        out["b"].append({"loss": loss,
                         "ms": (time.perf_counter() - t) * 1e3})
        torch.save({"loss": loss, "norms": norms,
                    "factors": [(P.cpu(), Qn.cpu()) for P, Qn in factors],
                    "q": cpu(state.comp["Q"]),
                    "err": {p: torch.stack([e[p] for e in errs]).cpu()
                            for p in state.comp["Q"]}},
                   os.path.join(outdir, f"sc_b{i + 1}.pt"))
        if i + 1 < SC_STEPS:
            params = cpu(dict(state.model.named_parameters()))
            torch.save({"params": params,
                        "opt": {"m": cpu(state.opt["m"]),
                                "v": cpu(state.opt["v"]),
                                "count": state.opt["count"].cpu()},
                        "step": torch.tensor(state.step, dtype=torch.int32)},
                       os.path.join(outdir, f"sc_state_b{i + 1}.pt"))
    del state, errs
    torch.cuda.empty_cache()
    state = init_train_state(cfg, tc, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    with FactorTap(comp) as tap:
        state, m = make_train_step(cfg, tc)(state, ds.batch(0))
    torch.cuda.synchronize()
    factors = tap.factors()
    norms = {}
    for (path, e), (P, Qn) in zip(state.comp["err"].items(), factors):
        norms[path] = [float((e.reshape(P.shape[0], Qn.shape[0])
                              + P @ Qn.mT).norm())]
    out["a"].append({"loss": float(m["loss"]),
                     "ms": (time.perf_counter() - t) * 1e3})
    torch.save({"loss": float(m["loss"]), "norms": norms,
                "factors": [(P.cpu(), Qn.cpu()) for P, Qn in factors],
                "q": cpu(state.comp["Q"]), "err": cpu(state.comp["err"])},
               os.path.join(outdir, "sc_a1.pt"))
    del state, factors
    torch.cuda.empty_cache()
    return out


def timed_collectives(torch, coll):
    """Wrap ``coll``'s collectives so each is timed with a sync on either
    side (gloo waits for the work queued before a collective anyway);
    returns (the one-element list of seconds they add to, a function that
    restores them)."""
    spent = [0.0]
    kept = {name: getattr(coll, name) for name in (
        "all_reduce", "all_gather", "reduce_scatter")}

    def timing(fn):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t
            return r
        return wrapped
    for name, fn in kept.items():
        setattr(coll, name, timing(fn))

    def restore():
        for name, fn in kept.items():
            setattr(coll, name, fn)
    return spent, restore


def sharded_compression_rank(torch, ops, coll, outdir: str, rank: int
                             ) -> dict:
    """16.3 on one rank: the cross-pod mode on ``SC_MESH`` (``SC_STEPS``
    steps, step ``i + 1`` from the parent's state after step ``i``), then
    the no-pod mode on ``SL_MESH`` (one step), each step held against the
    parent's references: the loss, each leaf's factors (``hat_err``), the
    rank's shards of the pods' error buffers (squared differences, summed
    over the shards by the parent), ``Q``'s hash, the schedule; ms, time
    inside collectives, bytes across ``pod``, peak memory."""
    import dataclasses
    import hashlib
    from repro_torch import configs, sharding
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import convert as LV
    from repro_torch.optim import compression as comp
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compression import CompressionConfig
    from repro_torch.training import (TrainConfig, init_train_state,
                                      make_train_step)
    from repro_torch.training.schedule import record_counter, step_collectives
    cfg = sl_config(dataclasses, configs)
    tc = sc_train_config(AdamWConfig, TrainConfig, CompressionConfig)
    ds = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=SL_SEQ, global_batch=SL_BATCH))
    out = {"steps": [], "shapes": []}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                 # 16.3's main path from here
    for label, shape, steps in (("b", SC_MESH, SC_STEPS), ("a", SL_MESH, 1)):
        if len(shape) == 3:
            mesh = make_host_mesh(shape[1], shape[2], pod=shape[0],
                                  device="cuda")
        else:
            mesh = make_host_mesh(*shape, device="cuda")
        sizes = dict(zip(mesh.mesh_dim_names, shape))
        nb = shape[0] * (shape[1] if len(shape) == 3 else 1)
        want = step_collectives(cfg, sizes, SL_BATCH // nb, SL_SEQ, 1,
                                tc.compression)
        t = time.perf_counter()
        state = init_train_state(cfg, tc, mesh=mesh)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        step = make_train_step(cfg, tc, mesh)
        layout = [leaf for leaf in LV.leaf_layout(state.model)
                  if leaf.path in state.comp["Q"]]
        if label == "b" and rank == 0:
            out["shapes"] = [(leaf.path, math.prod(leaf.local_shape[:-1]),
                              leaf.local_shape[-1]) for leaf in layout]
        for i in range(steps):
            load_s = 0.0
            if i:
                t = time.perf_counter()
                prev = torch.load(os.path.join(outdir, f"sc_b{i}.pt"),
                                  mmap=True)
                tree = torch.load(os.path.join(outdir,
                                               f"sc_state_b{i}.pt"),
                                  mmap=True)
                tree["comp"] = {"Q": prev["q"], "err": prev["err"]}
                state.load_tree(tree)
                del prev, tree
                torch.cuda.synchronize()
                load_s = time.perf_counter() - t
            ref = torch.load(os.path.join(outdir, f"sc_{label}{i + 1}.pt"),
                             mmap=True)
            spent, restore = timed_collectives(torch, coll)
            coll.reset_record()
            torch.cuda.synchronize()
            t = time.perf_counter()
            with FactorTap(comp) as tap:
                state, m = step(state, ds.batch(i))
            loss = float(m["loss"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            restore()
            got = record_counter(coll.record)
            leaves = {}
            for leaf, mine, theirs in zip(layout, tap.factors(),
                                          ref["factors"]):
                e_ref = ref["err"][leaf.path]
                if "pod" in sizes:
                    e_ref = e_ref[state.plan.coord["pod"]]
                d = state.comp["err"][leaf.path] - state.plan.shard(
                    e_ref, leaf.spec).to(state.plan.device)
                leaves[leaf.path] = {
                    "hat": hat_err(torch, mine, theirs) / max(
                        ref["norms"][leaf.path]),
                    "err_sq": float(torch.sum(torch.square(d.double()))),
                    "q_diff": float((state.comp["Q"][leaf.path].cpu()
                                     - ref["q"][leaf.path]).abs().max()),
                    "q_sha": hashlib.sha1(state.comp["Q"][leaf.path].cpu()
                                          .numpy().tobytes()).hexdigest(),
                    "norms": ref["norms"][leaf.path],
                    "key": [state.plan.coord.get("pod", 0)] + [
                        state.plan.coord[a] for i in range(leaf.ndim)
                        for a in sharding.dim_axes(leaf.spec, i)]}
            out["steps"].append({
                "mode": label, "step": i + 1, "loss": loss,
                "ref_loss": ref["loss"], "ms": ms, "init_s": init_s,
                "load_s": load_s, "collective_ms": spent[0] * 1e3,
                "ratio": float(m["compress_ratio"]),
                "grad_norm": float(m["grad_norm"]),
                "schedule": "" if got == want else
                f"extra {dict(got - want)} missing {dict(want - got)}",
                "collectives": len(coll.record),
                "pod_bytes": sum(c["bytes"] for c in coll.record
                                 if "pod" in c.get("axes", "").split("+")),
                "pod_payload": max([c["bytes"] for c in coll.record
                                    if "pod" in c.get("axes", "").split(
                                        "+")] + [0]),
                "coord": state.plan.coord, "leaves": leaves})
            del ref
        if label == "b":
            out["checksums"] = {
                n: hashlib.sha1(p.detach().contiguous().view(torch.uint8)
                                .cpu().numpy().tobytes()).hexdigest()
                for n, p in state.model.named_parameters()}
            out["specs"] = {n: p.spec for n, p in
                            state.model.named_parameters()}
            out["coord"] = state.plan.coord
        del state
        torch.cuda.empty_cache()
    out["launches"] = {n: c for n, c in ops.launches.items() if c}
    out["routes"] = {n: c for n, c in ops.route_launches.items() if c}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def sc_check(torch, ops, ref, ranks, refs, cfg) -> tuple:
    """16.3's readings from the ranks' results (``sharded_compression_
    rank``) and the references (``sc_references``): fails on a loss, a
    factor, an error buffer or a schedule outside its limit, ``Q`` or a
    replica not bitwise, or a kernel not launched; returns (its summary,
    its rows of the ``kernels`` line)."""
    import importlib
    from repro_torch.optim.compression import CompressionConfig
    from repro_torch.training.schedule import pod_bytes, step_collectives
    bm = importlib.import_module("repro_torch.kernels.block_matvec")
    comp = [r["comp"] for r in ranks]
    first = comp[0]
    steps = []
    for k, st in enumerate(first["steps"]):
        tag = f"16.3 {st['mode']} step {st['step']}"
        worst = {"loss": 0.0, "hat": 0.0, "err": 0.0, "q_diff": 0.0}
        for c in comp:
            s = c["steps"][k]
            if s["schedule"]:
                fail(f"{tag}: rank {c['steps'][k]['coord']}'s collectives "
                     f"are not the schedule: {s['schedule']}")
            worst["loss"] = max(worst["loss"],
                                abs(s["loss"] / s["ref_loss"] - 1))
            for path, leaf in s["leaves"].items():
                if leaf["q_sha"] != st["leaves"][path]["q_sha"]:
                    fail(f"{tag}: Q of {path} differs between ranks")
                worst["hat"] = max(worst["hat"], leaf["hat"])
                worst["q_diff"] = max(worst["q_diff"], leaf["q_diff"])
        for path in st["leaves"]:
            shards = {}
            for c in comp:
                leaf = c["steps"][k]["leaves"][path]
                shards[tuple(leaf["key"])] = leaf["err_sq"]
            for p, norm in enumerate(st["leaves"][path]["norms"]):
                sq = sum(v for key, v in shards.items() if key[0] == p)
                worst["err"] = max(worst["err"], sq ** 0.5 / norm)
        s0 = [c["steps"][k] for c in comp]
        steps.append({**{key: st[key] for key in (
            "mode", "step", "loss", "ref_loss", "ms", "collective_ms",
            "ratio", "grad_norm", "collectives", "pod_bytes", "pod_payload",
            "init_s", "load_s")}, "worst": worst,
            "ms_ranks": [x["ms"] for x in s0]})
        print(f"{tag}: loss {st['loss']:.6f} (one process "
              f"{st['ref_loss']:.6f}; {worst['loss']:.2e} relative, limit "
              f"{TOL_SC_LOSS:.0e}); M_hat = P Qn^T within {worst['hat']:.2e} "
              f"of ||M|| (limit {TOL_SC_HAT:.0e}), each pod's error buffer "
              f"{worst['err']:.2e} (limit {TOL_SC_ERR:.0e}); Q bitwise on "
              f"every rank "
              f"({worst['q_diff']:.1e} from one process); compress_ratio "
              f"{st['ratio']:.3f}; {st['ms']:.1f} ms, "
              f"{st['collective_ms'] / st['ms']:.1%} inside collectives; "
              f"{st['collectives']} collectives, {st['pod_bytes']} bytes "
              f"across pod a rank (largest {st['pod_payload']})")
        if worst["loss"] > TOL_SC_LOSS or worst["hat"] > TOL_SC_HAT or \
                worst["err"] > TOL_SC_ERR:
            fail(f"{tag}: {worst}")
    replicas = 0
    for n, spec in first["specs"].items():
        axes = sorted({a for e in spec if e
                       for a in ([e] if isinstance(e, str) else e)})
        for i, a in enumerate(comp):
            for b in comp[i + 1:]:
                if all(a["coord"][x] == b["coord"][x] for x in axes):
                    replicas += 1
                    if a["checksums"][n] != b["checksums"][n]:
                        fail(f"16.3: {n} differs between ranks at "
                             f"{a['coord']} and {b['coord']}")
    cc = CompressionConfig(rank=TR_RANK, min_size=SC_MIN_SIZE)
    sizes = dict(zip(("pod", "data", "model"), SC_MESH))
    rows = SL_BATCH // (SC_MESH[0] * SC_MESH[1])
    plain_pod = pod_bytes(step_collectives(cfg, sizes, rows, SL_SEQ))
    comp_pod = pod_bytes(step_collectives(cfg, sizes, rows, SL_SEQ, 1, cc))
    n_steps = SC_STEPS + 1
    want = {"block_matvec": len(first["shapes"]) * n_steps,
            "block_rmatvec": len(first["shapes"]) * n_steps}
    got = {n: first["launches"].get(n, 0) for n in want}
    print(f"16.3 {cfg.name} at full width, {SL_LAYERS} of 28 layers, rank "
          f"{TR_RANK}, min_size {SC_MIN_SIZE}: {SC_STEPS} steps on a "
          f"{SC_MESH} pod x data x model mesh (each pod its own gradient "
          f"and error buffers) and one on {SL_MESH}; {replicas} replica "
          f"pairs bitwise; across pod a step a rank: {comp_pod} bytes "
          f"compressed against {plain_pod} plain (the schedule; "
          f"{plain_pod / max(comp_pod, 1):.1f}x); peak memory per rank "
          + ", ".join(f"{c['peak_gb']:.2f}" for c in comp) + " GB; "
          f"launches {first['launches']} by route {first['routes']}")
    if got != want:
        fail(f"16.3: launches {got}, the accounting says {want}")
    if not comp_pod or max(s["pod_bytes"] for s in steps
                           if s["mode"] == "b") != comp_pod:
        fail(f"16.3: bytes across pod {[s['pod_bytes'] for s in steps]} "
             f"against the schedule's {comp_pod}")
    sums = compression_sweeps(torch, ops, ref, bm, torch.device("cuda"),
                              first["shapes"])
    kernels = [{"name": f"{name}/tf32x3[sharded compression]",
                "route": "cuda", "source": TF32_SOURCE,
                "replaces": REPLACES[name],
                "launches": first["routes"].get(f"{name}/tf32x3", 0),
                **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")}}
               for name, row in sums.items()]
    for k in kernels:
        if not k["launches"]:
            fail(f"{k['name']} was not launched by 16.3's path")
    last = [st for st in steps if st["mode"] == "b"][-1]
    summary = {"ms_step": last["ms"],
               "collective_share": last["collective_ms"] / last["ms"],
               "ms_step_no_pod": steps[-1]["ms"],
               "collective_share_no_pod": steps[-1]["collective_ms"]
               / steps[-1]["ms"],
               "steps": steps, "replica_pairs": replicas,
               "pod_bytes_plain": plain_pod, "pod_bytes_compressed": comp_pod,
               "peak_gb": [c["peak_gb"] for c in comp],
               "launches": first["launches"], "routes": first["routes"],
               "shapes": first["shapes"], "references": refs,
               "sweeps": sums}
    return summary, kernels


# 16.4: sharded prefill and decode (transformer.prefill / decode_step of
# a model built with a mesh) on SL_MESH, against one process on the same
# weights and tokens
SS_SEED = SEED + 170
SS_BATCH, SS_PROMPT = 8, 2048
SS_MAX_SEQ = 32768       # the decode_32k cell's cache: 16,384 slots a model rank
SS_STEPS = 8
# recurrentgemma-9b: one (rglru, rglru, local) group; after the prompt its
# 2048-slot ring is full, so every decode step wraps it
SS_RG_LAYERS, SS_RG_STEPS = 3, 2
SS_SMOKE_BATCH, SS_SMOKE_PROMPT, SS_SMOKE_STEPS, SS_SMOKE_MAX = 4, 24, 4, 32
# the full-width bf16 logits against one process, max |difference| over
# max |logit|: partial sums rounded to bf16 before the tensor-parallel
# all-reduce where one process rounds once, and the softmax summed over
# the ranks' slots (NVIDIA H100 80GB HBM3, 700 W; readings over the
# prefill and every step: qwen3-0.6b 5.05e-3, recurrentgemma-9b 5.78e-3,
# greedy tokens all equal).  A softmax not reduced over the ranks, or a
# slot written on the wrong rank, moves logits O(1)
TOL_SS_BF16 = 2e-2


def ss_cases(dataclasses, configs) -> list:
    """16.4's ``(label, cfg, batch, prompt, max_seq, steps)``."""
    out = [("qwen3-0.6b", dataclasses.replace(
        configs.get_config(SL_ARCH), num_layers=SL_LAYERS), SS_BATCH,
        SS_PROMPT, SS_MAX_SEQ, SS_STEPS),
        ("recurrentgemma-9b", dataclasses.replace(
            configs.get_config("recurrentgemma-9b"),
            num_layers=SS_RG_LAYERS), SS_BATCH, SS_PROMPT,
         SS_PROMPT + SS_RG_STEPS, SS_RG_STEPS)]
    for arch in configs.list_archs():
        out.append((arch + "-smoke",
                    configs.smoke_config(configs.get_config(arch)),
                    SS_SMOKE_BATCH, SS_SMOKE_PROMPT, SS_SMOKE_MAX,
                    SS_SMOKE_STEPS))
    return out


def ss_inputs(torch, cfg, B, P, steps) -> tuple:
    """The prompt, the decode steps' tokens and the VLM's patches (CPU
    tensors, from ``SS_SEED``)."""
    g = torch.Generator().manual_seed(SS_SEED)
    lead = (B, cfg.num_codebooks) if cfg.family == "audio" else (B,)
    prompt = torch.randint(0, cfg.vocab_size, lead + (P,), generator=g)
    toks = torch.randint(0, cfg.vocab_size, lead + (steps,), generator=g)
    pe = (torch.randn((B, cfg.patch_positions, cfg.d_model), generator=g)
          if cfg.family == "vlm" else None)
    return prompt, toks, pe


def ss_references(torch, M, dev, outdir) -> dict:
    """16.4's one-process runs on the card, each case's logits (prefill
    and every step) into ``outdir`` for the ranks; the MoE shard by shard
    (``moe_by_shard``).  Returns their times."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import transformer as T
    times = {}
    for label, cfg, B, P, L, steps in ss_cases(dataclasses, configs):
        prompt, toks, pe = ss_inputs(torch, cfg, B, P, steps)
        Pp = cfg.patch_positions if cfg.family == "vlm" else 0
        model = T.init_model(cfg, seed=SS_SEED, device=dev)
        cache = T.init_cache(cfg, B, L + Pp, dev)
        apply_moe = M.apply_moe
        if cfg.is_moe:
            M.apply_moe = moe_by_shard(torch, M, SL_MESH[0])
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, _ = T.prefill(model, prompt.to(dev), cache,
                                  patch_embeds=None if pe is None
                                  else pe.to(dev))
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t
            outs, ms = [logits.cpu()], []
            for i in range(steps):
                t = time.perf_counter()
                logits, _ = T.decode_step(model, cache,
                                          toks[..., i:i + 1].to(dev),
                                          P + Pp + i)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
                outs.append(logits.cpu())
        finally:
            M.apply_moe = apply_moe
        torch.save(outs, os.path.join(outdir, f"ss_{label}.pt"))
        times[label] = {"prefill_s": t_pre,
                        "decode_ms": sorted(ms)[len(ms) // 2]}
        del model, cache
        torch.cuda.empty_cache()
    return times


def sharded_serve_rank(torch, ops, coll, mesh, outdir: str) -> dict:
    """16.4 on one rank: each case served by the sharded model (its rows,
    its shards of the weights and the cache), every prefill's and step's
    collectives against the schedule and its launches counted, its rows'
    logits against the one-process references in ``outdir``."""
    import dataclasses
    from repro_torch import configs, sharding
    from repro_torch.core.parallel import Plan
    from repro_torch.models import transformer as T
    from repro_torch.training.schedule import (decode_collectives,
                                               prefill_collectives,
                                               record_counter)
    plan = Plan(mesh)
    sizes = plan.sizes
    out = {}
    for label, cfg, B, P, L, steps in ss_cases(dataclasses, configs):
        ref = torch.load(os.path.join(outdir, f"ss_{label}.pt"))
        prompt, toks, pe = ss_inputs(torch, cfg, B, P, steps)
        r0, r1 = T.batch_rows(plan, B)
        dev = plan.device
        Pp = cfg.patch_positions if cfg.family == "vlm" else 0
        bf16 = cfg.dtype == "bfloat16"
        torch.cuda.empty_cache()
        model = T.init_model(cfg, seed=SS_SEED, plan=plan)
        cache = T.init_cache(cfg, B, L + Pp, plan=plan)
        # serving's peak: the init draws each leaf whole in fp32 first
        torch.cuda.reset_peak_memory_stats()
        specs = T.resolved_cache_specs(cfg, mesh, B, L + Pp)
        shapes = T.cache_shapes(cfg, B, L + Pp)
        local_ok = all(tuple(t.shape) == sharding.local_shape(
            shapes[i][n][0], specs[i][n], sizes)
            for i, c in enumerate(cache) for n, t in c.items())
        kv_bytes = sum(c[n].numel() * c[n].element_size()
                       for c in cache for n in ("k", "v") if n in c)
        kv_whole = sum(math.prod(w[n][0]) * getattr(torch, cfg.dtype).itemsize
                       for w in shapes for n in ("k", "v") if n in w)
        spent, restore = timed_collectives(torch, coll)
        sched, launches, errs, agree, ms = [], [], [], [], []
        try:
            def check(logits, want, i):
                want = want[r0:r1].to(torch.float32)
                got = logits.detach().to(torch.float32).cpu()
                d = float((got - want).abs().max())
                errs.append(d / max(float(want.abs().max()), 1e-30)
                            if bf16 else d)
                agree.append(float((got.argmax(-1) == want.argmax(-1))
                                   .float().mean()))
            ops.reset_launches()
            coll.reset_record()
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, _ = T.prefill(model, prompt[r0:r1].to(dev), cache,
                                  patch_embeds=None if pe is None
                                  else pe[r0:r1].to(dev))
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t
            pre_coll = spent[0]
            got = record_counter(coll.record)
            want = prefill_collectives(cfg, sizes, r1 - r0, P, L + Pp)
            sched.append("" if got == want else
                         f"prefill: extra {dict(got - want)} missing "
                         f"{dict(want - got)}")
            launches.append({n: c for n, c in ops.launches.items() if c})
            n_coll = [len(coll.record)]
            check(logits, ref[0], 0)
            for i in range(steps):
                ops.reset_launches()
                coll.reset_record()
                t = time.perf_counter()
                logits, _ = T.decode_step(model, cache,
                                          toks[r0:r1, ..., i:i + 1].to(dev),
                                          P + Pp + i)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
                got = record_counter(coll.record)
                want = decode_collectives(cfg, sizes, r1 - r0, L + Pp)
                sched.append("" if got == want else
                             f"step {i}: extra {dict(got - want)} missing "
                             f"{dict(want - got)}")
                launches.append({n: c for n, c in ops.launches.items()
                                 if c})
                n_coll.append(len(coll.record))
                check(logits, ref[i + 1], i + 1)
        finally:
            restore()
        out[label] = {
            "prefill_s": t_pre, "decode_ms": ms,
            "collective_s": spent[0], "prefill_collective_s": pre_coll,
            "schedule": sched, "launches": launches, "collectives": n_coll,
            "errs": errs, "argmax_agree": agree,
            "local_shapes": local_ok, "kv_bytes": kv_bytes,
            "kv_whole_bytes": kv_whole, "rows": [r0, r1],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del model, cache
    return out


def ss_check(ranks, times, cfgs) -> dict:
    """16.4's readings from the ranks: each case's logits within its
    limit of one process, the collectives the schedule, the attention
    kernel launched once an attention layer a prefill and never in a
    decode step, the K/V a rank holds its share; printed, and returned."""
    summary = {}
    for label, cfg in cfgs.items():
        rows = [r["serve"][label] for r in ranks]
        first = rows[0]
        full = not label.endswith("-smoke")
        tol = TOL_SS_BF16 if cfg.dtype == "bfloat16" else TOL_SL_SMOKE
        n_attn = sum(k in ("attn", "local") for k in cfg.blocks)
        worst = max(max(r["errs"]) for r in rows)
        kv_share = first["kv_bytes"] / max(first["kv_whole_bytes"], 1)
        ms = sorted(first["decode_ms"])[len(first["decode_ms"]) // 2]
        total = first["prefill_s"] + sum(first["decode_ms"]) / 1e3
        row = {"prefill_s": first["prefill_s"], "decode_ms": ms,
               "decode_ms_steps": first["decode_ms"],
               "collective_share": first["collective_s"] / total,
               "prefill_collective_share":
                   first["prefill_collective_s"] / first["prefill_s"],
               "peak_gb": [r["peak_gb"] for r in rows], "max_err": worst,
               "limit": tol, "argmax_agree": min(min(r["argmax_agree"])
                                                 for r in rows),
               "kv_share": kv_share, "collectives": first["collectives"],
               "launches": first["launches"], "one_process": times[label]}
        summary[label] = row
        if full:
            print(f"16.4 {label} at full width ({cfg.num_layers} layers, "
                  f"bf16) on the {SL_MESH} mesh: "
                  f"{first['rows'][1] - first['rows'][0]} rows a rank, "
                  f"prefill "
                  f"{first['prefill_s']:.3f} s (one process "
                  f"{times[label]['prefill_s']:.3f} s), decode {ms:.1f} ms "
                  f"a step (median; one process "
                  f"{times[label]['decode_ms']:.1f} ms), "
                  f"{row['collective_share']:.1%} inside collectives "
                  f"(prefill {row['prefill_collective_share']:.1%}), peak "
                  + ", ".join(f"{x:.2f}" for x in row["peak_gb"])
                  + f" GB a rank; K/V a rank {kv_share:.4f} of the whole "
                  f"cache; logits within {worst:.2e} of one process (limit "
                  f"{tol:.0e}), greedy tokens agree on "
                  f"{row['argmax_agree']:.1%}; collectives a prefill / step "
                  f"{first['collectives'][0]} / {first['collectives'][1]}; "
                  f"launches prefill {first['launches'][0]}, a step "
                  f"{first['launches'][1]}")
        for r in ranks:
            v = r["serve"][label]
            if any(v["schedule"]):
                fail(f"16.4 {label}: rank {r['rank']}'s collectives are not "
                     f"the schedule: {[x for x in v['schedule'] if x][:2]}")
            if not v["local_shapes"]:
                fail(f"16.4 {label}: rank {r['rank']}'s cache shapes are not "
                     f"cache_specs' local shapes")
            if v["launches"][0].get("local_attention", 0) != n_attn or any(
                    x.get("local_attention", 0) for x in v["launches"][1:]):
                fail(f"16.4 {label}: rank {r['rank']} launched "
                     f"local_attention {[x.get('local_attention', 0) for x in v['launches']]}"
                     f", want {n_attn} a prefill and 0 a step")
        if worst > tol:
            fail(f"16.4 {label}: logits {worst} from one process, limit "
                 f"{tol}")
    smoke = {k: v["max_err"] for k, v in summary.items()
             if k.endswith("-smoke")}
    print(f"16.4 the ten archs' fp32 smoke configs, prefill + "
          f"{SS_SMOKE_STEPS} steps on the {SL_MESH} mesh against one process "
          f"(the MoE shard by shard): max |logit difference| "
          + ", ".join(f"{k[:-6]} {v:.1e}" for k, v in smoke.items())
          + f" (limit {TOL_SL_SMOKE:.0e}); collectives = the schedule and "
          f"local_attention once an attention layer a prefill on every rank")
    return summary


def sharded_lm_rank(outdir: str) -> int:
    """16, one of ``SL_RANKS`` gloo ranks sharing the card (this script
    with ``--sharded-lm-rank DIR``): 16.1's sharded steps and 16.2's smoke
    steps, the numbers into ``DIR/rank<r>.json`` (rank 0 also the gathered
    parameters into ``DIR/*.pt``) for the parent to compare."""
    import dataclasses
    import hashlib
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch import configs
    from repro_torch.core import collectives as coll
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.convert import gather_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training import (TrainConfig, init_train_state,
                                      make_train_step)
    from repro_torch.training.schedule import record_counter, step_collectives
    t_start = time.time()
    dist.init_process_group("gloo")
    rank = dist.get_rank()
    mesh = make_host_mesh(*SL_MESH, device="cuda")
    sizes = dict(zip(mesh.mesh_dim_names, SL_MESH))
    rows = SL_BATCH // SL_MESH[0]
    out = {"rank": rank, "coord": dict(zip(mesh.mesh_dim_names,
                                           mesh.get_coordinate()))}

    # 16.1 qwen3-0.6b at full width
    cfg = sl_config(dataclasses, configs)
    tc = sl_train_config(AdamWConfig, TrainConfig)
    ds = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=SL_SEQ, global_batch=SL_BATCH))
    t0 = time.perf_counter()
    state = init_train_state(cfg, tc, mesh=mesh)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    step = make_train_step(cfg, tc, mesh)
    want = step_collectives(cfg, sizes, rows, SL_SEQ)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t_ready = time.time()
    losses, norms, ms, sched, per_step, coll_s = [], [], [], [], [], []
    for i in range(SL_STEPS):
        # collectives timed, a sync on either side of each
        spent, restore = timed_collectives(torch, coll)
        before = dict(ops.launches), dict(ops.route_launches)
        coll.reset_record()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, ds.batch(i))
        loss = float(m["loss"])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        restore()
        coll_s.append(spent[0])
        losses.append(loss)
        norms.append(float(m["grad_norm"]))
        got = record_counter(coll.record)
        sched.append("" if got == want else
                     f"extra {dict(got - want)} missing {dict(want - got)}")
        per_step.append({
            "launches": {n: c - before[0].get(n, 0)
                         for n, c in ops.launches.items()
                         if c - before[0].get(n, 0)},
            "routes": {n: c - before[1].get(n, 0)
                       for n, c in ops.route_launches.items()
                       if c - before[1].get(n, 0)},
            "collectives": len(coll.record),
            "collective_bytes": sum(c["bytes"] for c in coll.record)})
    launches = {n: c for n, c in ops.launches.items() if c}
    out["lm"] = {"losses": losses, "grad_norms": norms, "ms_steps": ms,
                 "schedule": sched, "per_step": per_step,
                 "launches": launches,
                 "collective_ms": coll_s[-1] * 1e3,
                 "first_collective_ms": sum(coll_s[:-1]) * 1e3,
                 "ready_s": t_ready - t_start,
                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    out["lm"]["checksums"] = {
        n: hashlib.sha1(p.detach().contiguous().view(torch.uint8).cpu()
                        .numpy().tobytes()).hexdigest()
        for n, p in state.model.named_parameters()}
    out["lm"]["specs"] = {n: p.spec for n, p in
                          state.model.named_parameters()}
    t = time.perf_counter()
    full = gather_params(state.model, state.plan)
    if rank == 0:
        torch.save({n: x.cpu() for n, x in full.items()},
                   os.path.join(outdir, "lm.pt"))
    out["lm"]["gather_save_s"] = time.perf_counter() - t
    del state, full
    torch.cuda.empty_cache()

    # 16.2 the ten archs' smoke configs, one fp32 step each
    t_smoke = time.perf_counter()
    out["smoke"] = {}
    for arch in configs.list_archs():
        cfg, tc, batch = sl_smoke(configs, AdamWConfig, TrainConfig,
                                  DataConfig, SyntheticLMDataset, arch)
        st = init_train_state(cfg, tc, mesh=mesh)
        coll.reset_record()
        st, m = make_train_step(cfg, tc, mesh)(st, batch)
        out["smoke"][arch] = {
            "loss": float(m["loss"]),
            "schedule": record_counter(coll.record) == step_collectives(
                cfg, sizes, 4 // SL_MESH[0], 32)}
        full = gather_params(st.model, st.plan)
        if rank == 0:
            torch.save({n: x.cpu() for n, x in full.items()},
                       os.path.join(outdir, f"smoke_{arch}.pt"))
    out["smoke_s"] = time.perf_counter() - t_smoke

    # 16.3 compressed training across ranks
    t = time.perf_counter()
    out["comp"] = sharded_compression_rank(torch, ops, coll, outdir, rank)
    out["comp_s"] = time.perf_counter() - t
    torch.cuda.empty_cache()

    # 16.4 sharded prefill and decode
    t = time.perf_counter()
    out["serve"] = sharded_serve_rank(torch, ops, coll, mesh, outdir)
    out["serve_s"] = time.perf_counter() - t
    out["start_s"] = t_start
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def sharded_lm(torch, ops, ref, la, dev) -> tuple:
    """Phase 16 (see the module docstring); returns (its summary, its rows
    of the ``kernels`` line)."""
    import dataclasses
    import signal
    import tempfile
    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import local_attn
    from repro_torch.models import mlp as M
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training import (TrainConfig, init_train_state,
                                      make_train_step)
    t_phase = time.perf_counter()
    cfg = sl_config(dataclasses, configs)
    tc = sl_train_config(AdamWConfig, TrainConfig)
    ds = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=SL_SEQ, global_batch=SL_BATCH))
    # the one-process steps on the same weights and batches, first
    state = init_train_state(cfg, tc, device=dev)
    step = make_train_step(cfg, tc)
    one = {"losses": [], "ms": []}
    for i in range(SL_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, ds.batch(i))
        one["losses"].append(float(m["loss"]))
        torch.cuda.synchronize()
        one["ms"].append((time.perf_counter() - t) * 1e3)
    one_params = {n: p.detach().cpu() for n, p in
                  state.model.named_parameters()}
    del state
    smoke_one = {}
    for arch in configs.list_archs():
        scfg, stc, batch = sl_smoke(configs, AdamWConfig, TrainConfig,
                                    DataConfig, SyntheticLMDataset, arch)
        st = init_train_state(scfg, stc, device=dev)
        apply_moe = M.apply_moe
        if scfg.is_moe:
            M.apply_moe = moe_by_shard(torch, M, SL_MESH[0])
        try:
            st, m = make_train_step(scfg, stc)(st, batch)
        finally:
            M.apply_moe = apply_moe
        smoke_one[arch] = (float(m["loss"]), {
            n: p.detach().cpu() for n, p in st.model.named_parameters()})
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t_phase

    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_") as tmp:
        t = time.perf_counter()
        sc_refs = sc_references(torch, ops, dev, tmp)
        t_sc_ref = time.perf_counter() - t
        t = time.perf_counter()
        ss_times = ss_references(torch, M, dev, tmp)
        t_ss_ref = time.perf_counter() - t
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={SL_RANKS}", os.path.abspath(__file__),
               "--sharded-lm-rank", tmp]
        t = time.perf_counter()
        t_launch = time.time()
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True,
                                env=dict(os.environ, OMP_NUM_THREADS="2"))
        try:
            log = proc.communicate(timeout=SL_TIMEOUT)[0]
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            log = proc.communicate()[0]
            print(log[-6000:])
            fail(f"16: the {SL_RANKS} ranks did not finish in {SL_TIMEOUT} s")
        if proc.returncode != 0:
            print(log[-8000:])
            fail(f"16: torchrun exited {proc.returncode}")
        t_ranks = time.perf_counter() - t
        ranks = []
        for r in range(SL_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        lm_params = torch.load(os.path.join(tmp, "lm.pt"))
        smoke_params = {arch: torch.load(os.path.join(
            tmp, f"smoke_{arch}.pt")) for arch in configs.list_archs()}

    first = ranks[0]["lm"]
    print(f"16 seconds: the one-process references {t_ref:.1f}, the ranks "
          f"{t_ranks:.1f} (to their first step {ranks[0]['start_s'] - t_launch + first['ready_s']:.1f}"
          f", 16.1's steps {sum(first['ms_steps']) / 1e3:.1f}, of which the "
          f"first {first['ms_steps'][0] / 1e3:.1f} with "
          f"{first['first_collective_ms'] / 1e3:.1f} in collectives; gather "
          f"and save {first['gather_save_s']:.1f}; 16.2 "
          f"{ranks[0]['smoke_s']:.1f})")

    # 16.1 against the one-process steps
    for r in ranks:
        lm = r["lm"]
        if lm["losses"] != first["losses"]:
            fail(f"16.1: rank {r['rank']}'s losses {lm['losses']} are not "
                 f"rank 0's {first['losses']}")
        if any(lm["schedule"]):
            fail(f"16.1: rank {r['rank']}'s collectives are not the "
                 f"schedule: {lm['schedule']}")
    replicas = 0
    for n, spec in first["specs"].items():
        axes = sorted({a for e in spec if e
                       for a in ([e] if isinstance(e, str) else e)})
        for a in ranks:
            for b in ranks:
                if a["rank"] < b["rank"] and all(
                        a["coord"][x] == b["coord"][x] for x in axes):
                    replicas += 1
                    if a["lm"]["checksums"][n] != b["lm"]["checksums"][n]:
                        fail(f"16.1: {n} differs between ranks {a['rank']} "
                             f"and {b['rank']}, which hold the same shard")
    want = train_expected(cfg, 1, 0)
    want = {n: c for n, c in want.items() if c}
    bwd_route = la.bwd_route(torch.bfloat16, cfg.resolved_head_dim)
    for i, ps in enumerate(first["per_step"]):
        if ps["launches"] != want or ps["routes"] != {
                f"local_attention_bwd/{bwd_route}":
                want["local_attention_bwd"]}:
            fail(f"16.1 step {i}: launches {ps['launches']} by route "
                 f"{ps['routes']}; the accounting says {want}")
    loss_rel = abs(first["losses"][0] / one["losses"][0] - 1)
    rel, worst, entry = param_rel_errs(torch, lm_params, one_params)
    mrel, mworst, _ = param_rel_errs(torch, lm_params, one_params, True)
    ms_step = first["ms_steps"][1]
    share = first["collective_ms"] / first["ms_steps"][-1]
    peak = [r["lm"]["peak_gb"] for r in ranks]
    print(f"16.1 {cfg.name} at full width, {SL_LAYERS} of 28 layers, on a "
          f"{SL_MESH} data x model mesh of {SL_RANKS} gloo ranks sharing the "
          f"card (each rank: {SL_BATCH // SL_MESH[0]} x {SL_SEQ} tokens, "
          f"{cfg.num_heads // SL_MESH[1]} of {cfg.num_heads} query heads, "
          f"{cfg.num_kv_heads // SL_MESH[1]} K/V heads), bf16, loss_chunks "
          f"{SL_CHUNKS}: loss " + " ".join(f"{x:.4f}" for x in
                                         first["losses"])
          + f" (one process: " + " ".join(f"{x:.4f}" for x in one["losses"])
          + f"; step 1 {loss_rel:.2e} relative, limit {TOL_SL_LOSS:.0e}); "
          f"parameters after {SL_STEPS} steps within {rel:.2e} of their norm "
          f"({worst}; limit {TOL_SL_PARAMS:.0e}; largest entry {entry:.2e}; "
          f"the matrices within {mrel:.2e}, {mworst}, limit "
          f"{TOL_SL_MATRICES:.0e}); "
          f"{replicas} replica pairs bitwise; every step's collectives = the "
          f"schedule ({first['per_step'][0]['collectives']} a step, "
          f"{first['per_step'][0]['collective_bytes'] / 1e6:.1f} MB a rank); "
          f"launches a step {first['per_step'][0]['launches']} by route "
          f"{first['per_step'][0]['routes']}")
    print(f"16.1 {ms_step:.1f} ms a step (step 2, a sync on either side of "
          f"each collective; steps "
          + ", ".join(f"{x:.1f}" for x in first["ms_steps"])
          + f" ms; one process on the card {one['ms'][1]:.1f} ms), "
          f"{share:.1%} of step 2 inside collectives (gloo "
          f"through the host: four ranks on one card, not NCCL between "
          f"cards; {first['collective_ms']:.1f} ms of "
          f"{first['ms_steps'][-1]:.1f}), peak memory per rank "
          + ", ".join(f"{x:.2f}" for x in peak) + " GB; init "
          f"{ranks[0]['init_s']:.1f} s, gather + save "
          f"{first['gather_save_s']:.1f} s")
    if loss_rel > TOL_SL_LOSS:
        fail(f"16.1: the first loss {first['losses'][0]} vs one process "
             f"{one['losses'][0]}")
    if rel > TOL_SL_PARAMS or mrel > TOL_SL_MATRICES:
        fail(f"16.1: parameters {rel} of their norm from one process "
             f"(the matrices {mrel})")
    if not first["losses"][-1] < first["losses"][0]:
        fail(f"16.1: the loss did not fall: {first['losses']}")

    # 16.2 the smoke configs
    smoke = {}
    for arch in configs.list_archs():
        got = [r["smoke"][arch] for r in ranks]
        loss1, params1 = smoke_one[arch]
        lerr = abs(got[0]["loss"] - loss1)
        rel2, worst2, entry2 = param_rel_errs(torch, smoke_params[arch],
                                              params1)
        smoke[arch] = {"loss_err": lerr, "param_rel_err": rel2,
                       "param_worst": worst2, "param_max_entry_err": entry2}
        print(f"  16.2 {arch}-smoke fp32, one step on the {SL_MESH} mesh vs "
              f"one process{' (the MoE shard by shard)' if configs.get_config(arch).is_moe else ''}: "
              f"loss diff {lerr:.1e}, parameters {rel2:.1e} of their norm "
              f"({worst2}; limit {TOL_SL_SMOKE:.0e} for both), largest entry "
              f"{entry2:.1e}; collectives = the schedule on every rank: "
              f"{all(g['schedule'] for g in got)}")
        if not (lerr <= TOL_SL_SMOKE and rel2 <= TOL_SL_SMOKE
                and all(g["schedule"] for g in got)
                and all(g["loss"] == got[0]["loss"] for g in got)):
            fail(f"16.2 {arch}: {smoke[arch]}")

    # the attention kernels at the ranks' local heads
    g = torch.Generator(device=dev).manual_seed(SEED + 160)
    Hl, Kl = cfg.num_heads // SL_MESH[1], cfg.num_kv_heads // SL_MESH[1]
    rows = attention_bwd_path(torch, ops, ref, la, g, dev, shapes=[(
        "qwen3-0.6b local heads", SL_BATCH // SL_MESH[0], Hl, Kl, SL_SEQ,
        cfg.resolved_head_dim, SL_SEQ, None)])
    b_row, f_row = rows["qwen3-0.6b local heads"], \
        rows["forward qwen3-0.6b local heads"]
    kernels = [
        {"name": f"local_attention_bwd/{b_row['route']}[sharded lm]",
         "route": "cuda", "source": BWD_SOURCE, "replaces": BWD_REPLACES,
         "launches": first["launches"].get("local_attention_bwd", 0),
         **{k: b_row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms")}},
        {"name": "local_attention[sharded lm]", "route": "cuda",
         "source": SOURCES["local_attention"],
         "replaces": REPLACES["local_attention"],
         "launches": first["launches"].get("local_attention", 0),
         **{k: f_row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms")}}]
    for k in kernels:
        if not k["launches"]:
            fail(f"{k['name']} was not launched by the sharded LM's path")

    # 16.3 compressed training across ranks
    sc_summary, sc_kernels = sc_check(torch, ops, ref, ranks, sc_refs, cfg)
    kernels += sc_kernels

    # 16.4 sharded prefill and decode; the attention kernel there runs at
    # the shape of the row above (a rank's 4 x 2048 tokens, 8 of 16 query
    # heads, 4 K/V heads, D 128)
    ss_cfgs = {label: c for label, c, *_ in ss_cases(dataclasses, configs)}
    ss_summary = ss_check(ranks, ss_times, ss_cfgs)
    print(f"16.4 seconds: the one-process references {t_ss_ref:.1f}, the "
          f"ranks {ranks[0]['serve_s']:.1f}")
    kernels.append({
        "name": "local_attention[sharded serve]", "route": "cuda",
        "source": SOURCES["local_attention"],
        "replaces": REPLACES["local_attention"],
        "launches": sum(x.get("local_attention", 0)
                        for v in ranks[0]["serve"].values()
                        for x in v["launches"]),
        **{k: f_row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")}})
    summary = {"one_process": one, "ranks_s": t_ranks, "reference_s": t_ref,
               "lm": {key: first[key] for key in (
                   "losses", "grad_norms", "ms_steps", "launches",
                   "collective_ms", "per_step")},
               "peak_gb": peak, "loss_rel": loss_rel, "param_rel": rel,
               "collective_share": share, "replica_pairs": replicas,
               "smoke": smoke, "kernel_rows": rows,
               "seconds": time.perf_counter() - t_phase}
    summary["rank_start_s"] = ranks[0]["start_s"] - t_launch
    summary["smoke_s"] = ranks[0]["smoke_s"]
    summary["compressed"] = {**sc_summary, "reference_s": t_sc_ref,
                             "ranks_s": ranks[0]["comp_s"]}
    summary["serve"] = {"cases": ss_summary, "reference_s": t_ss_ref,
                        "ranks_s": ranks[0]["serve_s"],
                        "seconds": t_ss_ref + ranks[0]["serve_s"]}
    print(f"phase 16: {summary['seconds']:.1f} s (the one-process "
          f"references {t_ref:.1f} s, 16.3's {t_sc_ref:.1f} s and 16.4's "
          f"{t_ss_ref:.1f} s, the ranks {t_ranks:.1f} s: "
          f"{summary['rank_start_s']:.1f} s to start, 16.2 "
          f"{summary['smoke_s']:.1f} s, 16.3 {ranks[0]['comp_s']:.1f} s, "
          f"16.4 {ranks[0]['serve_s']:.1f} s; 16.4 in all "
          f"{summary['serve']['seconds']:.1f} s)")
    return summary, kernels


def main() -> int:
    if sys.argv[1:2] == ["--sharded-rank"]:      # one rank of phase 10.2
        return sharded_rank(*sys.argv[2:4])
    if sys.argv[1:2] == ["--sharded-lm-rank"]:   # one rank of phase 16
        return sharded_lm_rank(sys.argv[2])
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    import importlib

    import repro_torch
    from repro_torch.kernels import build, local_attn, ops, ref
    bm = importlib.import_module("repro_torch.kernels.block_matvec")
    gm = importlib.import_module("repro_torch.kernels.gram")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(card)                           # nvidia-smi name, power.limit
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    print("TF32 is off for matmul and cuDNN: the plain fp32 versions and "
          "the library yardsticks are full fp32 (the kernels' fp32 is FFMA or "
          "3xTF32, never plain TF32)")

    # -- 1. build ----------------------------------------------------------
    t_start = t0 = time.perf_counter()
    phase_s: dict = {}
    t_mark = [t_start]

    def mark(label: str) -> None:
        """Print and keep the seconds since the last mark."""
        now = time.perf_counter()
        phase_s[label] = now - t_mark[0]
        t_mark[0] = now
        print(f"phase {label}: {phase_s[label]:.1f} s")

    planted_builds = {key: build_planted(build, *key)
                      for key in PLANTED + TIMING + BWD_PLANTED}
    logs = build.build_all()
    planted = {}
    for (name, flag), (proc, path) in planted_builds.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            fail(f"nvcc {name}.cu -D{flag} failed:\n{out}")
        planted[(name, flag)] = path
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(logs) or 'up to date'}; and the planted faults of "
          f"phase 2b: " + ", ".join(f"{name} -D{flag}"
                                    for name, flag in PLANTED)
          + "; for timing: " + ", ".join(f"{name} -D{flag}"
                                         for name, flag in TIMING)
          + "; the backward's precision: " + ", ".join(
              f"{name} -D{flag}" for name, flag in BWD_PLANTED) + ")")
    for name, log in logs.items():       # nvcc -Xptxas=-v, per kernel
        regs = [int(l.split("Used ")[1].split()[0])
                for l in log.splitlines()
                if "Used " in l and "registers" in l]
        spills = [int(l.split()[4]) for l in log.splitlines()
                  if "spill stores" in l]
        if not regs:                     # staging.cu: host functions only
            print(f"  {name}: no kernels")
            continue
        print(f"  {name}: {len(regs)} kernels, registers <= {max(regs)}, "
              f"{sum(b > 0 for b in spills)} with spills (<= "
              f"{max(spills)} bytes stored)")
    attention_instances(build, local_attn, logs.get("local_attn") or (
        build.BUILD_DIR / "local_attn.log").read_text())
    attention_bwd_instances(build, local_attn, logs.get("local_attn_bwd") or (
        build.BUILD_DIR / "local_attn_bwd.log").read_text())
    # fp32 on the paths: TMA (CP 0) at the main path's width, cp.async of
    # 4 bytes (CP 1) at 32767 columns, of 8 (CP 2) at 8190; bf16 by TMA
    # (LD 0) on the solver's copy, by cp.async of 4 bytes (LD 4) at 8190,
    # with registers (LD 2) at 8191, of 8 bytes (LD 8) on padded views;
    # gram every instance (A^T A on the gram path, A A^T on the wide
    # input, cp.async at ragged widths; bf16 by TMA multicast, LD 0, and
    # by the producer's copies, LD 1)
    for name, tag, sd, want in (
            ("block_matvec_tc", "tc", "bf16",
             tuple(kern for ld in (0, 8, 4, 2)
                   for kern in (f"matvec_tc<32,{ld}>", f"rmatvec_tc<{ld}>"))),
            ("block_matvec_tf32", "tf32", "fp32",
             tuple(f"{kern}_tf32<32,{cp}>" for cp in (0, 1, 2)
                   for kern in ("matvec", "rmatvec"))),
            ("gram_tf32", "tf32", "fp32",
             tuple(f"gram_tf32<{trans},{cp}>" for trans in (0, 1)
                   for cp in (0, 1, 2))),
            ("gram_bf16", "bf16", "bf16",
             tuple(f"gram_bf16<{trans},{ld}>" for trans in (0, 1)
                   for ld in (0, 1)))):
        sweep_instances(build, name, logs.get(name) or (
            build.BUILD_DIR / f"{name}.log").read_text(), tag, sd, want)
    csr_instances(build, logs.get("csr_sweep") or (
        build.BUILD_DIR / "csr_sweep.log").read_text())
    wkv6_instances(logs.get("wkv6") or (
        build.BUILD_DIR / "wkv6.log").read_text())
    mark("1")

    if sys.argv[1:] == ["--only-out-of-core"]:    # phase 1, then phase 8
        print(json.dumps({"out_of_core": out_of_core(torch, repro_torch, ops,
                                                     dev)}))
        print(card_line())
        return 0
    if sys.argv[1:] == ["--only-sparse"]:         # phase 1, then phase 9
        summary, csr_rows, csr_launches = sparse_stream(
            torch, repro_torch, ops, ref, dev)
        print(json.dumps({"sparse": summary}))
        print(json.dumps({"kernels": csr_kernel_line(csr_rows,
                                                     csr_launches)}))
        print(card_line())
        return 0
    if sys.argv[1:] == ["--only-sharded"]:        # phase 1, then phase 10
        summary, _, _ = sharded(torch, repro_torch, ops, ref, bm, dev)
        print(json.dumps({"sharded": summary}))
        print(card_line())
        return 0
    if sys.argv[1:] == ["--only-training"]:       # phase 1, then phase 12
        summary, line = training(torch, ops, ref, local_attn, bm, dev,
                                 planted)
        mark("12")
        print(json.dumps({"training": summary}))
        print(json.dumps({"kernels": line}))
        print(card_line())
        return 0
    if sys.argv[1:] == ["--only-analysis"]:       # phase 1, then phase 13
        summary = analysis(torch, repro_torch, ops, dev)
        mark("13")
        print(json.dumps({"analysis": summary}))
        print(card_line())
        return 0
    if sys.argv[1:] == ["--only-lm-families"]:    # phase 1, then phase 14
        summary, line = lm_families(torch, ops, ref, local_attn, dev)
        mark("14")
        print(json.dumps({"lm_families": summary}))
        print(json.dumps({"kernels": line}))
        print(card_line())
        return 0
    if sys.argv[1:] == ["--only-recurrent-training"]:  # phase 1, then 15
        summary, line = recurrent_training(torch, ops, ref, local_attn, dev)
        mark("15")
        print(json.dumps({"recurrent_training": summary}))
        print(json.dumps({"kernels": line}))
        print(card_line())
        return 0
    if sys.argv[1:] == ["--only-sharded-lm"]:     # phase 1, then phase 16
        summary, line = sharded_lm(torch, ops, ref, local_attn, dev)
        mark("16")
        print(json.dumps({"sharded_lm": summary}))
        print(json.dumps({"kernels": line}))
        print(card_line())
        return 0
    if sys.argv[1:] == ["--only-serving"]:        # phase 1, then phase 11
        summary, line = serving(torch, repro_torch, ops, ref, bm, dev)
        mark("11")
        print(json.dumps({"serving": summary}))
        print(json.dumps({"kernels": line}))
        print(card_line())
        return 0

    # -- 2a. kernels vs plain at ragged shapes -----------------------------
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    # n in {300, 515, 4100, 2052, 1001, 2054} has bf16 rows a tensor map
    # cannot describe (n % 8 != 0): contiguous bf16 there is wgmma_ld; fp32
    # rows where n % 4 != 0 (515, 1001, 2054) run tf32x3_cpasync (cp.async
    # of 4 bytes, of 8 at 2054).  (5000, 1000, 7) and (3001, 2052, 45) are
    # ragged in m (not whole 256-row blocks), n (not whole stages: 64 bf16,
    # 32 fp32) and k (not a multiple of 8) on the tensor-core routes
    shapes = [(1000, 300, 7), (4097, 515, 40), (2048, 1024, 130),
              (3000, 200, 1), (257, 4100, 32), (40000, 96, 33),
              (5000, 1000, 7), (3001, 2052, 45), (5001, 1001, 7),
              (3001, 2054, 130)]
    worst = 0.0
    for (m, n, k) in shapes:
        A = torch.randn((m, n), generator=g, device=dev)
        Qn = torch.randn((n, k), generator=g, device=dev)
        Ym = torch.randn((m, k), generator=g, device=dev)
        for sd in ("float32", "bfloat16"):
            As = A.to(getattr(torch, sd))
            route = bm.route(As, k)
            ops.reset_launches()
            cases = [
                ("block_matvec", ops.block_matvec(As, Qn),
                 ref.block_matvec_ref(As, Qn, sd), TOL[sd]),
                ("block_rmatvec", ops.block_rmatvec(As, Ym),
                 ref.block_rmatvec_ref(As, Ym, sd), TOL[sd]),
                ("block_gram_chain", ops.block_gram_chain(As, Qn),
                 ref.block_gram_chain_ref(As, Qn, sd),
                 TOL_CHAIN_BF16 if sd == "bfloat16" else TOL[sd]),
                ("block_gram_chain[trans]",
                 ops.block_gram_chain(As, Ym, trans=True),
                 ref.block_gram_chain_ref(As, Ym, sd, trans=True),
                 TOL_CHAIN_BF16 if sd == "bfloat16" else TOL[sd]),
            ]
            torch.cuda.synchronize()
            ran = {n_: c for n_, c in ops.route_launches.items() if c}
            if ran != {f"block_matvec/{route}": 3,
                       f"block_rmatvec/{route}": 3}:
                fail(f"{sd} {(m, n, k)}: route {route}, launches {ran}")
            for name, got, want, tol in cases:
                if got.dtype != torch.float32 or got.shape != want.shape:
                    fail(f"{name} {sd} {(m, n, k)}: got {got.dtype} "
                         f"{tuple(got.shape)}")
                e = rel_err(torch, got, want)
                worst = max(worst, e / tol)
                print(f"  {name:24s} {sd:8s} ({route}) m={m} n={n} k={k}: "
                      f"rel err {e:.2e} (limit {tol:.0e})")
                if not e <= tol:
                    fail(f"{name} {sd} {(m, n, k)}: rel err {e} > {tol}")
    print(f"ragged shapes: all within limits (worst {worst:.2f} of limit)")
    worst = padded_views(torch, ops, ref, bm, g, dev)
    print(f"views of padded rows: all within limits (worst {worst:.2f} of "
          f"limit)")
    worst = deflation_ragged(torch, ops, ref, gm, g, dev)
    print(f"deflation kernels at ragged shapes: all within limits (worst "
          f"{worst:.2f} of limit)")
    mark("2a")

    # -- 2b/3. the main path's A ----------------------------------------
    t0 = time.perf_counter()
    A, s = spectral_matrix(torch, M, N, SEED, dev)
    torch.cuda.synchronize()
    print(f"A {M}x{N} fp32 ({A.numel() * 4 / 2**30:.0f} GiB) built on the "
          f"card in {time.perf_counter() - t0:.1f} s")

    # -- 2b. kernels at the main path's shape --------------------------------
    Q = torch.linalg.qr(torch.randn((N, K), generator=g, device=dev)).Q
    Ym = torch.randn((M, K), generator=g, device=dev)
    table = {(name, sd): row for sd in ("float32", "bfloat16")
             for name, row in sweep_rows(torch, ops, ref, bm, A, Q, Ym,
                                         sd).items()}
    del Q, Ym
    torch.cuda.empty_cache()
    for sd, lib, inputs in (("bfloat16", "block_matvec_tc", ("abs",)),
                            ("float32", "block_matvec_tf32",
                             ("abs", "signed"))):
        planted_faults(torch, bm, ref, {
            key: path for key, path in planted.items() if key[0] == lib
            and key in PLANTED and key[1] != "REPRO_NO_ZFILL"}, sd, g, dev,
            inputs)
    # the copying routes: rows 32767 elements apart (no tensor map; in
    # bf16 an odd stride, every other row by registers), 32765 of them
    # read; the columns past n are NaN, so a copy that reads them shows in
    # A Q.  In A^T Y they feed only output rows past n, which are never
    # stored: no reading of A^T Y can see that fault
    for sd, lib, inputs in (("float32", "block_matvec_tf32",
                             ("abs", "signed")),
                            ("bfloat16", "block_matvec_tc", ("abs",))):
        planted_faults(torch, bm, ref, {
            key: path for key, path in planted.items()
            if key[0] == lib and key in PLANTED}, sd, g, dev, inputs,
            width=N - 3, ld=N - 1, seen={"REPRO_NO_ZFILL": ("block_matvec",)})
    for lib, sd in (("gram_tf32", "float32"), ("gram_bf16", "bfloat16")):
        gram_planted_faults(torch, gm, ref, {
            key: path for key, path in planted.items()
            if key[0] == lib and key in PLANTED}, g, dev, sd)

    # -- 4. the gram-free kernels at the gram-free path's shape -------------
    v = torch.randn(N, generator=g, device=dev)
    Xv = torch.randn(M, generator=g, device=dev)
    Ud = torch.randn((M, K_GRAMFREE), generator=g, device=dev)
    c = torch.randn(K_GRAMFREE, generator=g, device=dev)
    dtable = {
        "matvec": time_kernel(
            torch, "matvec", lambda: ops.matvec(A, v),
            lambda: ref.matvec_ref(A, v), lambda: torch.mv(A, v), 5,
            TOL["float32"], deflation_bound("matvec", M, N)),
        "deflate_rmatvec": time_kernel(
            torch, "deflate_rmatvec",
            lambda: ops.deflate_rmatvec(A, Ud, Xv, c),
            lambda: ref.deflate_rmatvec_ref(A, Ud, Xv, c),
            lambda: (torch.mv(A.mT, Xv - Ud @ c), Ud.mT @ Xv), 5,
            TOL["float32"],
            deflation_bound("deflate_rmatvec", M, N, K_GRAMFREE)),
    }
    del v, Xv, Ud, c
    mark("2b and 4 (the main shape)")

    # -- 3. the main path (block) -----------------------------------------
    def solve(X, label, expect_trans=False, rtol=1e-4, route="tf32x3",
              **kw):
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        res = repro_torch.svd(X, K, **kw)
        counts = {n: c for n, c in ops.launches.items() if c}
        routes = {n: c for n, c in ops.route_launches.items() if c}
        it = int(res.iters[0])
        err = float((res.S.double().cpu() / s[:K].double().cpu() - 1)
                    .abs().max())
        print(f"{label}: iters {it}, passes_over_A {res.passes_over_A}, "
              f"bytes_per_pass {res.bytes_per_pass}, bytes_moved "
              f"{res.bytes_moved}, converged {res.converged}, wall_time_s "
              f"{res.wall_time_s:.3f}, launches {counts} (by route "
              f"{routes}), max sigma rel "
              f"err {err:.2e} (limit {rtol:.0e}), peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        want = {"block_gram_chain": it,
                "block_matvec": it + (0 if expect_trans else 1),
                "block_rmatvec": it + (1 if expect_trans else 0)}
        if counts != want:
            fail(f"{label}: launches {counts}, pass accounting implies "
                 f"{want}")
        # the chains run on `route`; the extraction reads the fp32 A
        want_routes = {f"{n}/{route}": it
                       for n in ("block_matvec", "block_rmatvec")}
        last = (f"{'block_rmatvec' if expect_trans else 'block_matvec'}/"
                f"{bm.route(X, K)}")
        want_routes[last] = want_routes.get(last, 0) + 1
        if routes != want_routes:
            fail(f"{label}: launches by route {routes}, want {want_routes}")
        if res.passes_over_A != 2 * it + 1 or res.backend != "dense":
            fail(f"{label}: passes {res.passes_over_A} for {it} iters")
        if not (res.converged and err <= rtol
                and bool(torch.isfinite(res.U).all())
                and bool(torch.isfinite(res.V).all())):
            fail(f"{label}: not converged to the prescribed sigma")
        return res, counts, routes

    def profile_solve(label, X=None, **kw):
        """Where a solve's device time goes (another solve of ``X``,
        default the main path's ``A``, profiled): busy and idle share, the
        sweep kernels' seconds, launches and ms a launch (the TMA and
        cp.async instances of the 3xTF32 kernels apart), the rest by
        time."""
        X = A if X is None else X
        calls: dict = {}
        res, wall, busy, n_act, names = profile_window(
            torch, lambda: repro_torch.svd(X, K, **kw), calls)
        if not n_act:
            print(f"profile of the {label} solve: not measured (the profiler "
                  f"saw no device activity)")
            return
        # demangled template arguments: <N, 0> TMA, <N, 1|2> cp.async
        keys = (("matvec_tf32", "::matvec_tf32<", ", 0>"),
                ("rmatvec_tf32", "::rmatvec_tf32<", ", 0>"),
                ("matvec_tf32 cp.async", "::matvec_tf32<", None),
                ("rmatvec_tf32 cp.async", "::rmatvec_tf32<", None),
                ("matvec_tc", "::matvec_tc", ""),
                ("rmatvec_tc", "::rmatvec_tc", ""),
                ("split_transpose", "split_transpose", ""),
                ("slab sum", "sum_slabs", ""))

        def of(key, tail, n_):
            if key not in n_:
                return False
            args = n_.split(key, 1)[1].split(">")[0] + ">"
            return (tail in args) if tail is not None else \
                not args.endswith(", 0>")
        sweeps = {lab: (sum(t for n_, t in names.items() if of(key, tail, n_)),
                        sum(c for n_, c in calls.items() if of(key, tail, n_)))
                  for lab, key, tail in keys}
        rest = sorted(((n_, t) for n_, t in names.items() if not any(
            of(key, tail, n_) for _, key, tail in keys)), key=lambda x: -x[1])
        print(f"profile of the {label} solve ({int(res.iters[0])} iters): "
              f"{wall:.3f} s under the profiler, device busy {busy:.3f} s "
              f"({100 * busy / wall:.1f} %, idle {100 * (1 - busy / wall):.1f}"
              f" %), {n_act} device activities; " + ", ".join(
                  f"{lab} {t:.4f} s ({c} launches, {1e3 * t / c:.3f} ms each)"
                  for lab, (t, c) in sweeps.items() if c)
              + "; the rest by time: " + ", ".join(
                  f"{n_[:48]} {t:.4f} s" for n_, t in rest[:6]))

    main_res, main_counts, main_routes = solve(A, f"main path svd(A, {K}) "
                                                  f"fp32")
    # seconds a step: the wall time over the solve's passes, two a step
    step_s = main_res.wall_time_s * 2 / main_res.passes_over_A
    profile_solve("fp32")
    bf16_kw = {"sweep_dtype": "bfloat16", "eps": 1e-4}
    _, bf16_counts, bf16_routes = solve(A, f"svd(A, {K}) bf16 sweeps",
                                        rtol=1e-2, route="wgmma", **bf16_kw)
    profile_solve("bf16", **bf16_kw)
    mark("3 (the main path)")

    # -- 5. the deflation paths ------------------------------------------
    counts = deflation_solve(
        torch, repro_torch, ops, A, K_GRAMFREE, "gramfree",
        f"gram-free path svd(A, {K_GRAMFREE}, method='gramfree') "
        f"{M}x{N}", s, table=dtable)
    path_counts = dict(counts)
    del A
    torch.cuda.empty_cache()

    Ag, _ = spectral_matrix(torch, M, N_GRAM, SEED + 4, dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    dtable["gram"] = time_kernel(
        torch, "gram", lambda: ops.gram(Ag), lambda: ref.gram_ref(Ag),
        lambda: torch.mm(Ag.mT, Ag), 2, gram_tol(M),
        deflation_bound("gram", M, N_GRAM), offdiag=True)
    ran = {n_: c for n_, c in ops.route_launches.items() if c}
    print(f"  gram's bound by FFMA alone (the fp32 peak, no tensor cores): "
          f"{gram_flop(M, N_GRAM) / PEAK_OPS['float32'] * 1e3:.2f} ms; "
          f"launches by route {ran}")
    if set(ran) != {"gram/tf32x3"}:
        fail(f"gram at {(M, N_GRAM)}: launches by route {ran}")
    # where its time goes: the planted-fault builds at the same shape;
    # plain TF32 keeps all of the staging and a third of the products
    for (lib, flag), path in planted.items():
        if lib == "gram_tf32" and (lib, flag) in PLANTED:
            dtable["gram"][f"ms_{flag.lower()}"] = planted_run(
                gm, lib, path, lambda: time_ms(
                    torch, lambda: gm.gram_cuda(Ag, "tf32x3"), 2))
    print(f"  gram with plain TF32 (a third of the products, all of the "
          f"staging): {dtable['gram']['ms_repro_tf32_only']:.3f} ms; with "
          f"the sums left in the tensor cores: "
          f"{dtable['gram']['ms_repro_tc_sums_only']:.3f} ms; the kernel "
          f"{dtable['gram']['ms']:.3f} ms")
    # bf16 gram (no solve runs it: the deflation engines are fp32) on the
    # bf16 tensor cores, A by TMA multicast: once through ops, then timed
    # beside torch.mm with fp32 out; where its time goes, from its builds
    # with the sums left in the tensor cores (no promotion adds) and with
    # no products at all (the staging alone)
    mm, LIBRARY["gram/wgmma"] = bf16_mm(torch, dev)
    for key in BF16_GRAM:
        LIBRARY[key] = LIBRARY["gram/wgmma"]
    dtable["gram/wgmma"], path_counts["gram/wgmma"], Agb = bf16_gram_row(
        torch, ops, ref, Ag, "gram/wgmma", mm)
    for (lib, flag), path in planted.items():
        if lib == "gram_bf16":
            dtable["gram/wgmma"][f"ms_{flag.lower()}"] = planted_run(
                gm, lib, path, lambda: time_ms(
                    torch, lambda: gm.gram_cuda(Agb, "wgmma"), 2))
    dtable["gram/wgmma"]["float64"] = float64_reading(torch, ops, ref, Agb)
    print(f"  bf16 gram with the sums left in the tensor cores: "
          f"{dtable['gram/wgmma']['ms_repro_tc_sums_only']:.3f} ms; its "
          f"staging alone (no products): "
          f"{dtable['gram/wgmma']['ms_repro_staging_only']:.3f} ms; the "
          f"kernel {dtable['gram/wgmma']['ms']:.3f} ms")
    del Agb
    counts = deflation_solve(
        torch, repro_torch, ops, Ag, K_GRAM, "gram",
        f"gram path svd(A, {K_GRAM}, method='gram') {M}x{N_GRAM}", s,
        table=dtable)
    path_counts["gram"] = counts["gram"]
    del Ag
    torch.cuda.empty_cache()
    # the gram path one column short: rows of 4 * 8191 bytes, which no
    # tensor map describes, nor the engine's residual of the same rows
    Ago, _ = spectral_matrix(torch, M, N_GRAM - 1, SEED + 9, dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    dtable["gram/tf32x3_cpasync"] = time_kernel(
        torch, "gram/tf32x3_cpasync", lambda: ops.gram(Ago),
        lambda: ref.gram_ref(Ago), lambda: torch.mm(Ago.mT, Ago), 2,
        gram_tol(M), deflation_bound("gram", M, N_GRAM - 1), offdiag=True)
    ran = {n_: c for n_, c in ops.route_launches.items() if c}
    if set(ran) != {"gram/tf32x3_cpasync"}:
        fail(f"gram at {(M, N_GRAM - 1)}: launches by route {ran}")
    counts = deflation_solve(
        torch, repro_torch, ops, Ago, K_GRAM, "gram",
        f"odd-width gram path svd(A, {K_GRAM}, method='gram') "
        f"{M}x{N_GRAM - 1}", s, table={
            "gram": dtable["gram/tf32x3_cpasync"], "matvec": dtable["matvec"]},
        gram_route="tf32x3_cpasync")
    path_counts["gram/tf32x3_cpasync"] = counts["gram"]
    # bf16 of the same rows: odd lda, every other row 2 bytes off a 4-byte
    # boundary (no tensor map: the producer's own copies, boxes pushed
    # between the blocks of 2 x 2 clusters), with its staging alone
    dtable["gram/wgmma_ld"], path_counts["gram/wgmma_ld"], Agob = \
        bf16_gram_row(torch, ops, ref, Ago, "gram/wgmma_ld", mm)
    del Ago
    torch.cuda.empty_cache()
    staging_ld(torch, gm, planted, dtable["gram/wgmma_ld"], Agob)
    padded_yardstick(torch, ops, gm, Agob)
    for key in ("gram/tf32x3_cpasync", *BF16_GRAM):
        REPLACES[key] = REPLACES["gram"]
    del Agob
    torch.cuda.empty_cache()
    mark("5 and 4 (gram)")

    # rows of 4 * 8190 bytes: no tensor map; fp32 runs 3xTF32 with A copied
    # by cp.async (8 bytes a copy: the rows start 8-byte aligned)
    Ao, _ = spectral_matrix(torch, *ODD, SEED + 5, dev)
    solve(Ao, f"odd width {ODD[0]}x{ODD[1]} svd(A, {K}) fp32",
          route="tf32x3_cpasync")
    go = torch.Generator(device=dev).manual_seed(SEED + 6)
    Qo = torch.linalg.qr(torch.randn((ODD[1], K), generator=go,
                                     device=dev)).Q
    Yo = torch.randn((ODD[0], K), generator=go, device=dev)
    for name, row in sweep_rows(torch, ops, ref, bm, Ao, Qo, Yo,
                                "float32").items():
        if row["route"] != "tf32x3_cpasync":
            fail(f"{name} at {ODD}: route {row['route']}, not tf32x3_cpasync")
        table[(name, "tf32x3_cpasync", ODD)] = row
    # wgmma_ld's path: a bf16 A of rows no tensor map describes, handed to
    # ops directly (the solver pads its own bf16 copy): rows of 16380
    # bytes (4-byte aligned: cp.async of 4 bytes), then of 16382 (an odd
    # stride: every other row 2 bytes off, copied through registers)
    ld_counts = {}
    for name, row in wgmma_ld_rows(torch, ops, ref, bm, planted, Ao, Qo, Yo,
                                   ld_counts).items():
        table[(name, "wgmma_ld", ODD)] = row
    del Ao, Qo, Yo
    torch.cuda.empty_cache()
    Al, _ = spectral_matrix(torch, *ODD_LDA, SEED + 10, dev)
    gl = torch.Generator(device=dev).manual_seed(SEED + 11)
    Ql = torch.linalg.qr(torch.randn((ODD_LDA[1], K), generator=gl,
                                     device=dev)).Q
    Yl = torch.randn((ODD_LDA[0], K), generator=gl, device=dev)
    for name, row in wgmma_ld_rows(torch, ops, ref, bm, planted, Al, Ql, Yl,
                                   ld_counts).items():
        table[(name, "wgmma_ld", ODD_LDA)] = row
    del Al, Ql, Yl
    torch.cuda.empty_cache()

    # the paper's shard one column short: no fp32 tensor map (4-byte
    # copies, rows 4 * 32767 bytes apart); the bf16 copy padded to 32768
    t0 = time.perf_counter()
    As, _ = spectral_matrix(torch, *ODD_SHARD, SEED + 7, dev)
    torch.cuda.synchronize()
    print(f"A {ODD_SHARD[0]}x{ODD_SHARD[1]} fp32 "
          f"({As.numel() * 4 / 1e9:.1f} GB) built on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    _, odd_counts, odd_routes = solve(
        As, f"odd-width shard svd(A, {K}) fp32", route="tf32x3_cpasync")
    profile_solve("odd-width fp32", As)
    _, odd16_counts, odd16_routes = solve(
        As, f"odd-width shard svd(A, {K}) bf16 sweeps", rtol=1e-2,
        route="wgmma", **bf16_kw)
    profile_solve("odd-width bf16", As, **bf16_kw)
    Qs = torch.linalg.qr(torch.randn((ODD_SHARD[1], K), generator=go,
                                     device=dev)).Q
    Ys = torch.randn((ODD_SHARD[0], K), generator=go, device=dev)
    for name, row in sweep_rows(torch, ops, ref, bm, As, Qs, Ys,
                                "float32").items():
        if row["route"] != "tf32x3_cpasync":
            fail(f"{name} at {ODD_SHARD}: route {row['route']}")
        table[(name, "tf32x3_cpasync")] = row
    del As, Qs, Ys
    torch.cuda.empty_cache()
    Aw, _ = spectral_matrix(torch, *WIDE, SEED + 2, dev)
    solve(Aw, f"wide {WIDE[0]}x{WIDE[1]} svd(A, {K}) fp32",
          expect_trans=True)
    for method in ("gramfree", "gram"):
        deflation_solve(torch, repro_torch, ops, Aw, K_WIDE, method,
                        f"wide {WIDE[0]}x{WIDE[1]} svd(A, {K_WIDE}, "
                        f"method={method!r})", s)
    # A A^T of the wide input in bf16 (the kernel's K-major layout), and of
    # the wide input one column short (rows of 131071: wgmma_ld)
    dtable["gram/wgmma[trans]"], path_counts["gram/wgmma[trans]"], Awb = \
        bf16_gram_row(torch, ops, ref, Aw, "gram/wgmma[trans]", mm,
                      trans=True)
    del Awb
    dtable["gram/wgmma_ld[trans]"], path_counts["gram/wgmma_ld[trans]"], \
        Awb = bf16_gram_row(torch, ops, ref, Aw[:, :-1],
                            "gram/wgmma_ld[trans]", mm, trans=True)
    del Aw
    torch.cuda.empty_cache()
    staging_ld(torch, gm, planted, dtable["gram/wgmma_ld[trans]"], Awb,
               trans=True)
    del Awb
    mark("3 (odd widths, wide) and 5 (wide)")

    # -- 6. determinism --------------------------------------------------
    Ar, _ = spectral_matrix(torch, *RERUN, SEED + 3, dev)
    Aro, _ = spectral_matrix(torch, *RERUN_ODD, SEED + 8, dev)
    for X, kw, fp32_route in ((Ar, {}, "tf32x3"),
                              (Ar, {"method": "gramfree"}, None),
                              (Ar, bf16_kw, "tf32x3"),
                              (Aro, {}, "tf32x3_cpasync")):
        k = K_GRAMFREE if "method" in kw else K
        ops.reset_launches()
        r1, r2 = repro_torch.svd(X, k, **kw), repro_torch.svd(X, k, **kw)
        routes = sorted({n_.split("/")[1]
                         for n_, c in ops.route_launches.items() if c})
        same = all(torch.equal(a, b) for a, b in zip(r1[:3], r2[:3]))
        print(f"rerun {X.shape[0]}x{X.shape[1]} svd(A, {k}"
              + "".join(f", {key}={val!r}" for key, val in kw.items())
              + f"): routes {routes}, U, S, V bitwise equal: {same}")
        if fp32_route is not None and fp32_route not in routes:
            fail(f"the block rerun pair ({kw}) ran routes {routes}, not the "
                 f"fp32 operand's {fp32_route}")
        if not same:
            fail(f"two solves with the same seed differ ({kw})")
    # gram on tf32x3, tf32x3_cpasync, wgmma, wgmma_ld
    for X in (Ar, Aro, Ar.to(torch.bfloat16), Aro.to(torch.bfloat16)):
        for trans in (False, True):
            same = torch.equal(ops.gram(X, trans=trans),
                               ops.gram(X, trans=trans))
            print(f"rerun gram {X.shape[0]}x{X.shape[1]} ({gm.route(X)}, "
                  f"trans={trans}): bitwise equal: {same}")
            if not same:
                fail(f"two gram runs of {tuple(X.shape)} (trans={trans}) "
                     f"differ")

    del Ar, Aro
    torch.cuda.empty_cache()
    mark("6")

    # -- 7. the LM serving path ------------------------------------------
    dtable["local_attention"], path_counts["local_attention"] = lm_serving(
        torch, ops, ref, local_attn, g, dev)
    mark("7")

    # -- 8. the out-of-core tiers -----------------------------------------
    ooc = out_of_core(torch, repro_torch, ops, dev)
    print(json.dumps({"out_of_core": ooc}))
    mark("8")

    # -- 9. the paper's sparse stream, and resume -------------------------
    summary, csr_rows, csr_launches = sparse_stream(
        torch, repro_torch, ops, ref, dev, rate=ooc["h2d"]["pinned"])
    print(json.dumps({"sparse": summary}))
    mark("9")

    # -- 10. the paper's N-GPU layout -------------------------------------
    sh_summary, sh_counts, sh_rows = sharded(torch, repro_torch, ops, ref,
                                             bm, dev, time_rows=True)
    print(json.dumps({"sharded": sh_summary}))
    mark("10")

    # -- 11. the SVD service ----------------------------------------------
    sv_summary, sv_line = serving(torch, repro_torch, ops, ref, bm, dev,
                                  table=table)
    print(json.dumps({"serving": sv_summary}))
    mark("11")

    # -- 12. training -----------------------------------------------------
    tr_summary, tr_line = training(torch, ops, ref, local_attn, bm, dev,
                                   planted)
    print(json.dumps({"training": tr_summary}))
    mark("12")

    # -- 13. the static contract checker, the dry run, the examples ---------
    an_summary = analysis(torch, repro_torch, ops, dev, step_s)
    print(json.dumps({"analysis": an_summary}))
    mark("13")

    # -- 14. the other LM families, served at full width -----------------
    lf_summary, lf_line = lm_families(torch, ops, ref, local_attn, dev)
    print(json.dumps({"lm_families": lf_summary}))
    mark("14")

    # -- 15. training of the recurrent families ----------------------------
    rt_summary, rt_line = recurrent_training(torch, ops, ref, local_attn,
                                             dev)
    print(json.dumps({"recurrent_training": rt_summary}))
    mark("15")

    # -- 16. the sharded LM on four ranks sharing the card -----------------
    sl_summary, sl_line = sharded_lm(torch, ops, ref, local_attn, dev)
    print(json.dumps({"sharded_lm": sl_summary}))
    mark("16")

    sweeps = ("block_matvec", "block_rmatvec", "block_gram_chain")
    rows = dict(dtable)
    # the fp32 solve's sweeps (3xTF32), the bf16 solve's chains (wgmma) and
    # the odd-width shard's fp32 solve (3xTF32, A by cp.async)
    for name in sweeps:
        for which, key, counts, routes, source in (
                ("tf32x3", "float32", main_counts, main_routes, TF32_SOURCE),
                ("wgmma", "bfloat16", bf16_counts, bf16_routes, TC_SOURCE),
                ("tf32x3_cpasync", "tf32x3_cpasync", odd_counts, odd_routes,
                 TF32_SOURCE)):
            rows[f"{name}/{which}"] = table[(name, key)]
            path_counts[f"{name}/{which}"] = routes.get(f"{name}/{which}",
                                                        counts[name])
            SOURCES[f"{name}/{which}"] = source
            REPLACES[f"{name}/{which}"] = REPLACES[name]
        # bf16 handed to ops with rows no tensor map describes (launches:
        # the chain through ops at each width, their path)
        for label, shape in (("wgmma_ld", ODD), ("wgmma_ld[odd lda]", ODD_LDA)):
            key = f"{name}/{label}"
            rows[key] = table[(name, "wgmma_ld", shape)]
            path_counts[key] = ld_counts[(name, shape)]
            SOURCES[key] = TC_SOURCE
            REPLACES[key] = REPLACES[name]
    print(f"odd-width shard bf16 solve: launches {odd16_counts}, by route "
          f"{odd16_routes}")
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name], "launches": path_counts[name],
        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        **({"library_causal_ms": row["library_causal_ms"]}
           if "library_causal_ms" in row else {})}
        for name, row in rows.items()] + csr_kernel_line(
            csr_rows, csr_launches) + sharded_kernel_line(
            sh_counts, table, dtable, sh_rows) + sv_line + tr_line + lf_line \
        + rt_line + sl_line
    print(json.dumps({"block_sweeps_by_route": [
        {"name": name, "dtype": "float32" if key[0] in (
            "float32", "tf32x3_cpasync") else "bfloat16",
         **table[(name, *key)]}
        for key in (("float32",), ("bfloat16",), ("tf32x3_cpasync",),
                    ("tf32x3_cpasync", ODD), ("wgmma_ld", ODD),
                    ("wgmma_ld", ODD_LDA))
        for name in sweeps]}))
    print(json.dumps({"kernels": kernels}))
    print("seconds by phase: " + ", ".join(f"{p} {t:.1f}"
                                           for p, t in phase_s.items())
          + f"; in all {time.perf_counter() - t_start:.1f}")
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
