"""Serving launcher: batched prefill + decode loop (the PyTorch port).

    python -m repro_torch.launch.serve --arch gemma2-9b      # one card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \\
        --smoke --device cpu --batch 2 --prompt-len 16 --tokens 8

The port of the JAX package's ``repro/launch/serve.py``, with the same
arguments plus ``--device``: random weights from seed 0, as there
(nothing is downloaded), a random prompt batch, one batched prefill (its
attention on the hand-written ``local_attention`` kernel), then
``--tokens`` decode steps, greedy at ``--temperature 0`` (the default).
It runs on the card unless ``--device cpu`` is given, and raises where
no card is visible and no device was asked for.  Temperature sampling
draws from a ``torch.Generator``, so its tokens cannot match the JAX
package's ``jax.random``; greedy decoding is the path the two share.

Every architecture of ``configs/`` serves: the recurrent blocks run
their recurrences on the ``rglru_scan`` and ``wkv6`` kernels, the MoE
its capacity dispatch; the VLM's prefill takes zero patch embeddings
ahead of the prompt, as the JAX package's launcher does, so its caches
hold ``patch_positions`` more positions and its decode starts after
them; audio prompts are (batch, K, prompt_len) grids and each step
picks a token per codebook.

The phases are functions (``build``, ``make_prompt``, ``serve_prefill``,
``serve_decode``, ``decode_start``) so that a caller can time and count
them apart, as ``chip_smoke.py`` does.

``--mesh DATA,MODEL`` (or ``POD,DATA,MODEL``) serves the sharded model on
the ranks ``torchrun`` starts, with the same mesh policy as
``launch/train.py`` (its ``--mesh``; gloo on the CPU, and on the card
where ranks share one)::

    PYTHONPATH=src torchrun --standalone --nproc_per_node 4 \
        -m repro_torch.launch.serve --mesh 2,2 --arch qwen3-0.6b --smoke \
        --device cpu

Each rank holds its shards of the weights (``init_model(..., plan=)``:
FSDP over ``data``, tensor parallel over ``model``), its rows of the
prompt batch (over ``pod`` and ``data``) and its shard of the caches
(``transformer.cache_specs``: the KV ring's time axis over ``model``, so
decode attention is context parallel).  A step's collectives are
``training/schedule.py``'s ``prefill_collectives`` and
``decode_collectives``; the logits are whole on every rank of a row
block, so the greedy tokens are too.  The tokens are gathered over the
batch axes at the end, every rank holds them all, and rank 0 prints.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import sharding
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.core import parallel
from repro_torch.core.operator import resolve_device
from repro_torch.launch.mesh import mesh_from_arg
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(arch: str, *, smoke: bool = False, device=None,
          seed: int = 0, mesh=None) -> T.Transformer:
    """The model of ``arch`` (its smoke reduction with ``smoke``) with
    random weights from ``seed``, on ``device`` (``None``: the card); with
    ``mesh``, the rank's shards of it."""
    cfg = get_config(arch)
    if smoke:
        cfg = smoke_config(cfg)
    if mesh is not None:
        return T.init_model(cfg, seed=seed, plan=parallel.Plan(mesh))
    return T.init_model(cfg, seed=seed, device=resolve_device(device))


def make_prompt(cfg: ModelConfig, batch: int, prompt_len: int, *,
                seed: int = 0, device=None) -> torch.Tensor:
    """Uniform random token ids (batch, prompt_len) (audio: (batch, K,
    prompt_len)) from ``seed``."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = ((batch, cfg.num_codebooks, prompt_len)
             if cfg.family == "audio" else (batch, prompt_len))
    return torch.randint(0, cfg.vocab_size, shape, generator=g, device=dev)


def patch_positions(cfg: ModelConfig) -> int:
    """Positions the VLM's patch embeddings take ahead of the prompt."""
    return cfg.patch_positions if cfg.family == "vlm" else 0


def decode_start(cfg: ModelConfig, prompt_len: int) -> int:
    """The position of the first decode step after a prompt."""
    return prompt_len + patch_positions(cfg)


def serve_prefill(model: T.Transformer, prompt: torch.Tensor, max_seq: int,
                  *, patch_embeds: torch.Tensor | None = None):
    """Fresh caches for ``max_seq`` token positions (plus the VLM's
    patch positions), then the prompt's prefill; the VLM's
    ``patch_embeds`` (B, P, D) default to zeros.  Returns (last logits
    (B, V) (audio (B, K, V)), cache, seconds to the device's end).  A
    sharded model takes the whole batch's ``prompt`` and serves its rows
    (``transformer.batch_rows``): the logits and cache are theirs."""
    dev = prompt.device
    cfg = model.cfg
    P = patch_positions(cfg)
    if P and patch_embeds is None:
        patch_embeds = torch.zeros((prompt.shape[0], P, cfg.d_model),
                                   dtype=torch.float32, device=dev)
    px = parallel.plan_of(model.embed)
    cache = T.init_cache(cfg, prompt.shape[0], max_seq + P, dev, plan=px)
    r0, r1 = T.batch_rows(px, prompt.shape[0])
    prompt = prompt[r0:r1]
    if P:
        patch_embeds = patch_embeds[r0:r1]
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = T.prefill(model, prompt, cache,
                              patch_embeds=patch_embeds if P else None)
    _sync(dev)
    return logits, cache, time.perf_counter() - t0


def serve_decode(model: T.Transformer, cache: list, logits: torch.Tensor,
                 start: int, n_tokens: int, *, temperature: float = 0.0,
                 generator: torch.Generator | None = None):
    """``n_tokens`` decode steps from position ``start``: pick each next
    token from ``logits`` (argmax, or a sample at ``temperature``; audio
    one per codebook) and run it.  Returns (tokens (B, n_tokens) (audio
    (B, K, n_tokens)), the last step's logits, seconds to the device's
    end)."""
    dev = logits.device
    out = []
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(n_tokens):
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            nxt = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                                    generator=generator)
            nxt = nxt.view(logits.shape[:-1])
        else:
            nxt = torch.argmax(logits, dim=-1)        # (B,) or (B, K)
        out.append(nxt)
        logits, cache = T.decode_step(model, cache, nxt[..., None],
                                      start + i)
    _sync(dev)
    tokens = (torch.stack(out, dim=-1) if out else
              torch.empty((*logits.shape[:-1], 0), dtype=torch.long,
                          device=dev))
    return tokens, logits, time.perf_counter() - t0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default; needs a card) or 'cpu'")
    ap.add_argument("--mesh", default=None,
                    help="DATA,MODEL or POD,DATA,MODEL (under torchrun), "
                         "or 'production'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mesh = None if args.mesh is None else mesh_from_arg(args.mesh, dev)
    first = mesh is None or torch.distributed.get_rank() == 0
    model = build(args.arch, smoke=args.smoke, device=dev, mesh=mesh)
    dev = model.embed.device
    cfg = model.cfg
    B, P = args.batch, args.prompt_len
    prompt = make_prompt(cfg, B, P, device=dev)
    logits, cache, t_pre = serve_prefill(model, prompt, P + args.tokens)
    P0 = decode_start(cfg, P)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    if mesh is not None:
        where += " mesh=" + "x".join(f"{n}{k}" for n, k in zip(
            mesh.mesh_dim_names, mesh.mesh.shape))
    if first:
        print(f"{cfg.name} on {where}: prefill({P} tok x{B}): {t_pre:.3f}s")
    gen = (torch.Generator(device=dev).manual_seed(0)
           if args.temperature > 0 else None)
    tokens, _, t_dec = serve_decode(model, cache, logits, P0, args.tokens,
                                    temperature=args.temperature,
                                    generator=gen)
    px = parallel.plan_of(model.embed)
    if px is not None:                   # every rank: the whole batch's
        tokens = px.unshard(tokens, sharding.resolve_spec(
            ("batch",), px.mesh, (B,)))
    if first:
        print(f"decode {args.tokens} steps x{B}: {t_dec:.3f}s "
              f"({args.tokens * B / max(t_dec, 1e-9):.1f} tok/s)")
        print("seq0:",
              tokens[0].reshape(-1, tokens.shape[-1])[0, :20].tolist())
    return {"tokens": tokens, "prefill_s": t_pre, "decode_s": t_dec}


if __name__ == "__main__":
    main()
