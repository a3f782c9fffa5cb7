"""The port's static contract checker (``repro_torch.analysis``) catches
known-bad steps and passes the real solver clean, on the CPU.

One case for each of ``tests/test_analysis.py``'s tests: each trace/
memory rule gets a deliberately-broken step (two all-reduces, a wrong
payload, a stray all-gather, a bf16 product returning bf16, an fp32 step
under ``requires_bf16``, a float64 tensor, an ``.item()`` inside the
step, an oversized buffer) and the test asserts THAT rule fires; the
lint rules get minimal source snippets.  Then the full analyzer as the
CLI runs it must come out clean, its accounting groups must expect the
bytes the JAX package's own operators (``repro.core.operator``) count at
the same shapes, it must leave a process group already in the process as
it found it, and a planted bad step must make the CLI exit nonzero.

The collectives of the known-bad steps run on a world-1 gloo group: the
module's own, or the one another test module left in this process.
"""
import ast
import json
import os
import tempfile
import textwrap

import pytest
import torch
import torch.distributed as dist

from repro_torch.analysis import run_all
from repro_torch.analysis.allowlist import (ALLOWLIST, apply_allowlist,
                                            stale_entries)
from repro_torch.analysis.lint import lint_tree
from repro_torch.analysis.memory import check_memory
from repro_torch.analysis.report import AnalysisReport, CheckRecord, Violation
from repro_torch.analysis.trace_check import (StepContract, check_step,
                                              collective_schedule, trace_step)
from repro_torch.core.collectives import all_gather, all_reduce
from repro_torch.kernels import ops

N, K, M_LOC = 32, 4, 16


@pytest.fixture(scope="module")
def group():
    """A world-1 gloo group (made here unless one exists) for the steps'
    collectives."""
    made = not dist.is_initialized()
    if made:
        store = tempfile.mkstemp(prefix="repro_torch_analysis_")[1]
        os.unlink(store)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=0, world_size=1)
    yield dist.group.WORLD
    if made:
        dist.destroy_process_group()


def _rules(violations):
    return {v.rule for v in violations}


def _args(dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    return (torch.randn((M_LOC, N), generator=g).to(dtype),
            torch.randn((N, K), generator=g))


ONE_ALL_REDUCE = StepContract(all_reduce_payloads=((N, K),))


def _check(step, contract, tag, *args):
    return check_step(trace_step(step, *(args or _args())), contract, tag)


# ---------------------------------------------------------------------------
# trace pass: each contract rule fires on its known-bad step
# ---------------------------------------------------------------------------

def test_good_step_is_clean(group):
    def step(A, Q):
        return all_reduce(ops.block_gram_chain(A, Q), group)

    v, d = _check(step, ONE_ALL_REDUCE, "good")
    assert v == []
    assert d["n_all_reduce"] == 1


def test_two_all_reduces_fail_collective_count(group):
    def step(A, Q):
        AQ = all_reduce(ops.block_matvec(A, Q), group)      # unfused half
        return all_reduce(ops.block_rmatvec(A, AQ), group)

    v, _ = _check(step, ONE_ALL_REDUCE, "two-all-reduces")
    assert "collective-count" in _rules(v)


def test_wrong_payload_fails_collective_payload(group):
    def step(A, Q):
        # the (m_loc, k) product all-reduced instead of the (n, k) iterate
        return ops.block_rmatvec(A, all_reduce(ops.block_matvec(A, Q), group))

    v, _ = _check(step, ONE_ALL_REDUCE, "payload")
    assert "collective-payload" in _rules(v)


def test_stray_all_gather_fails(group):
    def step(A, Q):
        A_full = all_gather(A, group)
        return all_reduce(ops.block_gram_chain(A_full[:A.shape[0]], Q), group)

    v, _ = _check(step, ONE_ALL_REDUCE, "gather")
    assert "stray-collective" in _rules(v)


def test_bf16_product_returning_bf16_fails():
    def step(A, Q):
        return A.to(torch.bfloat16) @ Q.to(torch.bfloat16)

    v, _ = _check(step, StepContract(requires_bf16=True), "bf16-bad")
    assert "bf16-accum" in _rules(v)


def test_bf16_sweep_with_fp32_sums_is_clean():
    def step(A, Q):
        return ops.block_matvec(A, Q, dtype="bfloat16")

    v, d = _check(step, StepContract(requires_bf16=True), "bf16-good")
    assert v == []
    assert d["n_bf16_widened"] >= 1 and d["n_bf16_products"] == 0


def test_fp32_trace_fails_requires_bf16():
    def step(A, Q):
        return ops.block_matvec(A, Q)

    v, _ = _check(step, StepContract(requires_bf16=True), "no-bf16")
    assert "bf16-not-applied" in _rules(v)


def test_f64_upcast_fails():
    def step(A, Q):
        return (A @ Q).to(torch.float64)

    v, _ = _check(step, StepContract(), "f64")
    assert "f64-upcast" in _rules(v)


def test_item_in_step_fails_host_sync():
    def step(A, Q):
        out = A @ Q
        if out.norm().item() > 0:          # a host read inside the step
            return out
        return -out

    v, _ = _check(step, StepContract(), "item")
    assert "host-sync" in _rules(v)


def test_seeded_draws_do_not_confuse_dtype_checks():
    # a generator's state is a uint8 tensor; drawing from it must not read
    # as a dtype or a host-sync finding
    def step(A, Q):
        g = torch.Generator().manual_seed(0)
        return A @ (Q + torch.randn(Q.shape, generator=g))

    v, _ = _check(step, StepContract(), "generator")
    assert v == []


def test_collective_schedule_reports_all_reduce_bytes(group):
    def step(A, Q):
        return all_reduce(ops.block_gram_chain(A, Q), group)

    sched = collective_schedule(trace_step(step, *_args()))
    assert [c["op"] for c in sched] == ["all_reduce"]
    assert sched[0]["bytes"] == N * K * 4


# ---------------------------------------------------------------------------
# memory pass
# ---------------------------------------------------------------------------

def test_oversized_buffer_fails_budget():
    def step(A, Q):
        return A @ Q

    tr = trace_step(step, *_args())
    v, d = check_memory(tr, "big", budget_bytes=64)   # absurdly small
    assert _rules(v) == {"budget"}
    assert d["peak_live_bytes"] > 64

    v, _ = check_memory(tr, "fits", budget_bytes=1 << 30)
    assert v == []


def test_peak_live_bytes_counts_inputs_and_outputs():
    def step(A, Q):
        return A @ Q

    tr = trace_step(step, *_args())
    # A + Q live from entry, the output while it exists: at least their sum
    assert tr.resident_bytes == (M_LOC * N + N * K) * 4
    assert tr.peak_live_bytes >= (M_LOC * N + N * K + M_LOC * K) * 4


def test_a_bytes_count_only_the_sweeps():
    def step(A, Q):
        small = Q.mT @ Q                        # not a sweep over A
        return ops.block_rmatvec(A, ops.block_matvec(A, Q)) @ small

    a_nbytes = M_LOC * N * 4
    tr = trace_step(step, *_args())
    assert tr.a_bytes["a_bytes"] == 2 * a_nbytes
    _, d = check_memory(tr, "sweeps")
    assert d["a_read_bytes"] == 2 * a_nbytes
    tr16 = trace_step(lambda A, Q: ops.block_gram_chain(A, Q, dtype="bfloat16"),
                      *_args())
    assert tr16.a_bytes["a_bytes"] == a_nbytes      # 2 sweeps at 2 bytes


# ---------------------------------------------------------------------------
# lint pass
# ---------------------------------------------------------------------------

def _lint(src, relpath="core/fake.py"):
    return lint_tree(ast.parse(textwrap.dedent(src)), relpath)


def test_lint_flags_float_in_loop():
    v = _lint("""
        def drive(gaps):
            for g in gaps:
                if float(g) < 1e-6:
                    break
    """)
    assert _rules(v) == {"ANA001"}


def test_lint_sanctioned_sync_helper_is_clean():
    v = _lint("""
        def host_sync_scalar(x):
            while hasattr(x, "item"):
                x = x.item()
            return x
    """)
    assert v == []


def test_lint_flags_item_asarray_tolist_cpu_and_synchronize_in_loop():
    v = _lint("""
        import numpy as np
        import torch
        def drive(xs):
            for x in xs:
                y = x.item()
                z = np.asarray(x)
                w = x.tolist()
                c = x.cpu()
                torch.cuda.synchronize()
    """)
    assert len([x for x in v if x.rule == "ANA001"]) == 5


def test_lint_flags_frozen_state_mutation():
    v = _lint("""
        def advance(state):
            state.it = state.it + 1
    """)
    assert _rules(v) == {"ANA002"}


def test_lint_flags_raw_generator_outside_the_seed_helper():
    v = _lint("""
        import torch
        def sketch(seed):
            return torch.Generator().manual_seed(seed)
    """)
    assert _rules(v) == {"ANA003"}
    assert _rules(_lint("""
        import torch
        def draw(seed):
            torch.manual_seed(seed)
    """)) == {"ANA003"}
    assert _lint("""
        import torch
        def seeded_generator(device, seed):
            return torch.Generator(device=device).manual_seed(seed)
    """, relpath="core/tsvd.py") == []


def test_lint_flags_accounting_bypass():
    v = _lint("""
        def cheat(state):
            return state.replace(passes=0)
    """)
    assert "ANA004" in _rules(v)
    assert _lint("""
        def _stamp(state, d):
            return state.replace(passes=state.passes + d)
    """) == []


def test_lint_flags_uncached_compile_in_function():
    v = _lint("""
        import torch
        def step(A, Q):
            return torch.compile(lambda a, q: a @ q)(A, Q)
    """)
    assert _rules(v) == {"ANA005"}
    assert _lint("""
        import functools, torch
        @functools.lru_cache(maxsize=None)
        def step_fn(dtype):
            return torch.compile(lambda a, q: a @ q)
    """) == []


# ---------------------------------------------------------------------------
# allowlist + report plumbing
# ---------------------------------------------------------------------------

def test_apply_allowlist_marks_known_exception():
    key = next(iter(ALLOWLIST))
    target, rule = key.rsplit("::", 1)
    known = Violation("lint", rule, target, "msg")
    fresh = Violation("lint", "ANA001", "core/fake.py::f", "msg")
    out = apply_allowlist([known, fresh])
    assert out[0].allowlisted and out[0].reason == ALLOWLIST[key]
    assert not out[1].allowlisted


def test_stale_allowlist_entries_are_flagged():
    # no violations at all -> EVERY entry is stale
    stale = stale_entries([])
    assert {v.target for v in stale} == set(ALLOWLIST)
    assert all(v.rule == "stale-allowlist" for v in stale)


def test_report_json_shape():
    rep = AnalysisReport()
    rep.add([Violation("trace", "collective-count", "t", "m")],
            CheckRecord("trace", "t", "ok", {"n_all_reduce": 2}))
    d = json.loads(rep.to_json())
    assert d["ok"] is False
    assert d["checks"][0]["pass_name"] == "trace"
    assert d["checks"][0]["status"] == "violation"
    assert d["violations"][0]["rule"] == "collective-count"
    assert AnalysisReport().to_dict()["ok"] is True


# ---------------------------------------------------------------------------
# the real solver, as the CLI runs it
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def full_report():
    return run_all(device="cpu")


def test_real_solver_passes_clean(full_report):
    assert full_report.ok, "\n".join(
        f"{v.target}::{v.rule}: {v.message}" for v in full_report.failures)


def test_real_run_covers_all_passes(full_report):
    seen = {c.pass_name for c in full_report.checks}
    assert {"trace", "memory", "lint"} <= seen
    tags = {c.target for c in full_report.checks}
    for family in ("dense/", "sharded/", "hostblocked/", "memmap/",
                   "sparsestream/", "scipysparse/", "kernels/",
                   "sharded/deflation/faithful", "sharded/deflation/opt",
                   "twin:sharded/block/float32~sharded/block/bfloat16"):
        assert any(t.startswith(family) for t in tags), family


def test_real_run_accounting_groups_match(full_report):
    acct = [c for c in full_report.checks
            if c.target.startswith("accounting:")]
    assert len(acct) == 12
    for c in acct:
        assert c.details["measured_bytes"] == c.details["expected_bytes"], c


def test_accounting_groups_expect_the_jax_packages_bytes(full_report):
    """Each group's expected bytes equal what the JAX package's operators
    (``repro.core.operator`` and friends, built by its own analyzer's
    registry at the same shapes) count."""
    from repro.analysis.targets import build_targets as ref_targets
    _, ref_groups, _ = ref_targets()
    want = {g.name: g.expected_bytes for g in ref_groups}
    got = {c.target.split(":", 1)[1]: c.details["expected_bytes"]
           for c in full_report.checks if c.target.startswith("accounting:")}
    assert got == want


def test_run_all_twice_beside_an_existing_group(group):
    world = dist.group.WORLD
    for _ in range(2):
        rep = run_all(device="cpu", passes=("trace", "memory"))
        assert rep.ok
        assert dist.is_initialized() and dist.group.WORLD is world
        assert dist.get_world_size() == 1


def test_cli_writes_every_pass_and_exits_zero(tmp_path):
    from repro_torch.analysis.__main__ import main
    path = tmp_path / "r.json"
    assert main(["--device", "cpu", "--json", str(path)]) == 0
    d = json.loads(path.read_text())
    assert d["ok"] and {c["pass_name"] for c in d["checks"]} == {
        "trace", "memory", "lint"}


def test_cli_exits_nonzero_on_a_planted_bad_step(monkeypatch, capsys):
    from repro_torch.analysis import targets
    from repro_torch.analysis.__main__ import main
    real = targets.build_targets

    def planted(device):
        t, g, w, c = real(device)

        def bad(A, Q):
            return A @ Q if (A @ Q).sum().item() else Q
        t.append(targets.StepTarget("planted/item", bad, _args(),
                                    StepContract()))
        return t, g, w, c

    monkeypatch.setattr(targets, "build_targets", planted)
    assert main(["--device", "cpu", "--pass", "trace"]) == 1
    assert "planted/item" in capsys.readouterr().out


def test_run_all_without_a_device_raises_with_no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_all()
