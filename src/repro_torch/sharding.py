"""Logical-axis sharding rules (the port of the JAX package's
``repro/sharding.py``).

Every parameter dimension carries a *logical* name; the rules table maps
logical names onto physical mesh axes, so changing the parallel layout
means editing ONE table, not the model code.

Physical mesh axes (``launch/mesh.py``):

* ``pod``   — slowest axis, between pods (multi-pod runs only);
* ``data``  — FSDP + batch data parallelism;
* ``model`` — tensor (and expert-internal) parallelism.

Default layout = FSDP(data) x TP(model) x DP(pod): weights FSDP-shard
their "long" dim over ``data`` and TP-shard heads / ffn / vocab / rnn
width over ``model``; the batch splits over (pod, data).

``resolve_spec`` returns a plain tuple, the ``PartitionSpec``
counterpart: one entry a dim, ``None`` (replicated), an axis name, or a
tuple of axis names (flat shard index row-major over them), trailing
``None``s trimmed.  It takes a ``DeviceMesh`` or any object that names
its axes and sizes (``axis_names`` + ``shape``, as the JAX package's
``AbstractMesh``; or a dict ``{axis: size}``), so the production meshes
resolve without ranks.

The JAX package's ``use_mesh`` and ``constrain`` are hints to GSPMD and
have no counterpart: the port's layers issue their collectives
themselves (``core/parallel.py``), and a rank holds exactly the shards
its specs give.  Training: the weights as above, the batch's rows over
``(pod, data)``.  Serving (``models/transformer.py::cache_specs``): the
same weights and rows, and each layer's cache with the KV ring's time
axis over ``model`` (``"cache_seq"``), so a decode step's attention is
context parallel (one ``all_reduce_max`` and one ``all_reduce`` over
``model`` a layer); the per-step collectives are
``training/schedule.py``'s.  ``placements`` gives the DTensor placements
of a spec, for the checkpoint boundary only.
"""
from __future__ import annotations

import contextlib
import threading

# logical axis -> physical mesh axis (or tuple, or None)
DEFAULT_RULES: dict[str, object] = {
    # global batch is split across pod and data axes
    "batch": ("pod", "data"),
    "seq": None,            # sequence kept whole by default (SP off)
    "embed": None,          # activation embed dim replicated
    # parameter dims
    "vocab": "model",       # embedding/lm-head vocab dim -> TP
    "embed_p": "data",      # parameter embed dim -> FSDP
    "heads": "model",       # q heads -> TP
    "kv_heads": "model",    # kv heads -> TP (falls back below if indivisible)
    "qkv": None,            # per-head feature dim
    "mlp": "model",         # ffn hidden -> TP
    "expert": None,         # experts unsharded (internal dims are sharded)
    "rnn": "model",         # recurrent width -> TP
    "seq_shard": "model",   # context-parallel fallback (heads % tp != 0)
    "cache_seq": "model",   # decode KV cache: shard the TIME axis over TP
                            # (kv_heads rarely divide 16; 32k positions
                            #  always do — keeps grok's 1.1TB cache at
                            #  4.3GB/chip)
    "layers": None,         # stacked-scan leading dim
    "window": None,
    "codebook": None,
}

_STATE = threading.local()


def get_rules() -> dict[str, object]:
    return getattr(_STATE, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def rules(overrides: dict[str, object]):
    """Temporarily override logical->physical rules."""
    old = get_rules()
    _STATE.rules = {**old, **overrides}
    try:
        yield
    finally:
        _STATE.rules = old


def mesh_axes(mesh) -> dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh``, of an object with
    ``axis_names`` and ``shape`` (a mapping or a tuple), or of a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                          # DeviceMesh
        return {n: mesh.size(i) for i, n in enumerate(names)}
    names = tuple(mesh.axis_names)
    shape = mesh.shape
    if isinstance(shape, dict) or hasattr(shape, "keys"):
        return {n: int(shape[n]) for n in names}
    return dict(zip(names, map(int, shape)))


def resolve_spec(logical: tuple, mesh, dim_sizes: tuple | None = None
                 ) -> tuple:
    """Map a tuple of logical names to a spec tuple for ``mesh``.

    Drops axes the mesh doesn't have (``pod`` on one pod), never uses a
    mesh axis twice, and drops any mapping that doesn't divide the
    dimension (kv_heads=1 over model=16 falls back to replicated), so
    one config stays portable across meshes."""
    table = get_rules()
    sizes = mesh_axes(mesh)
    out: list = []
    used: set[str] = set()
    for i, name in enumerate(logical):
        phys = None if name is None else table.get(name, None)
        if phys is None:
            out.append(None)
            continue
        axes = (phys,) if isinstance(phys, str) else tuple(phys)
        axes = tuple(a for a in axes if a in sizes and a not in used)
        if not axes:
            out.append(None)
            continue
        if dim_sizes is not None:
            total = 1
            for a in axes:
                total *= sizes[a]
            if dim_sizes[i] % total != 0:
                out.append(None)
                continue
        used.update(axes)
        out.append(axes[0] if len(axes) == 1 else axes)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def dim_axes(spec: tuple, i: int) -> tuple[str, ...]:
    """The mesh axes dim ``i`` of a resolved spec is sharded over."""
    if i >= len(spec) or spec[i] is None:
        return ()
    return (spec[i],) if isinstance(spec[i], str) else tuple(spec[i])


def local_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """The shape of one rank's shard of a ``shape`` tensor under
    ``spec``."""
    sizes = mesh_axes(mesh)
    out = []
    for i, n in enumerate(shape):
        k = 1
        for a in dim_axes(spec, i):
            k *= sizes[a]
        out.append(n // k)
    return tuple(out)


def placements(spec: tuple, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``):
    ``Shard(i)`` on each mesh dim that shards tensor dim ``i``,
    ``Replicate()`` on the others.  A dim over several axes shards over
    each in turn, as the flat index is row-major over them."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i in range(len(spec)):
        for a in dim_axes(spec, i):
            out[names.index(a)] = Shard(i)
    return out
