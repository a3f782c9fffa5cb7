"""Trace contract pass: collectives, precision, purity of one step.

The port's counterpart of the JAX package's ``repro/analysis/
jaxpr_check.py``.  The solver's performance story is a set of schedule
invariants:

* **collective contract** — one sharded block step issues exactly ONE
  all-reduce, of the ``(n, k)`` iterate (``(n + k,)`` for the fused
  deflation step, three for the paper-faithful one); no stray
  ``all_gather``/``reduce_scatter`` sneaks in;
* **precision contract** — a bf16 step reads A at bf16 and sums in fp32
  (no matrix product of bf16 operands returns bf16), an fp32 step reads
  it at fp32, and nothing upcasts to float64;
* **purity contract** — a step waits for the card nowhere: host syncs
  live outside it, behind the driver's lagged read.

PyTorch has no jaxpr, so ``trace_step(fn, *args)`` RUNS the step once at
small shapes under a recorder of three sources:

(a) a ``TorchDispatchMode`` over the aten ops: the dtype census, the
    matrix products, the host syncs (``aten._local_scalar_dense`` — an
    ``.item()``, ``float()`` or ``bool()`` of a tensor —
    ``aten._linalg_check_errors``, ``nonzero`` and a blocking copy from
    the card to the host), and the storages live during the step
    (``analysis/memory.py``);
(b) ``core/collectives.py``'s ``record``: op, shape, dtype, bytes and
    group size of every collective;
(c) ``kernels/ops.py``'s ``thread_launches()`` and ``thread_a_bytes()``:
    the hand-written kernels launched, by route, and the bytes of A the
    sweeps read.

The hand-written kernels are bound by ``ctypes``: the dispatcher never
sees them, so on the card only (c) shows what they did.  The precision
contract reads (c) there — a bf16 step must launch the ``wgmma`` or
``wgmma_ld`` routes (or the CSR sweeps' bf16 forms), an fp32 step the
``tf32x3`` ones — and (a) on the CPU, where the plain versions round A to
bf16 and widen it to fp32 before an fp32 product (``kernels/ref.py``):
there the check looks for that widening.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.report import Violation

__all__ = ["StepContract", "StepTrace", "trace_step", "check_step",
           "collective_schedule"]

#: aten ops that are matrix products (the dot census)
_PRODUCTS = frozenset({"mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot",
                       "vdot", "matmul", "linear", "_scaled_mm"})

#: aten ops that wait for the card on their own
_SYNC_OPS = frozenset({"_local_scalar_dense", "_linalg_check_errors",
                       "nonzero", "is_nonzero", "equal"})

_NARROW = (torch.bfloat16, torch.float16)


@dataclasses.dataclass(frozen=True)
class StepContract:
    """What one traced step is allowed to do.

    ``all_reduce_payloads`` is the exact multiset of the shapes its
    all-reduces carry; its length IS the required all-reduce count.
    ``requires_bf16`` asserts the narrow sweep happened (a bf16 config
    whose trace reads A at fp32 silently fell back — drift, not a win).
    """

    all_reduce_payloads: tuple = ()     # e.g. ((160, 8),): one (n, k)
    allowed_collectives: frozenset = frozenset()   # besides all_reduce
    requires_bf16: bool = False
    forbid_f64: bool = True


@dataclasses.dataclass
class StepTrace:
    """What one run of a step did (see the module's docstring)."""

    device: str
    dtypes: dict                # dtype census: dtype -> op outputs of it
    products: list              # (op, input dtypes, output dtype)
    f64_ops: list               # ops that touched a float64 tensor
    syncs: list                 # host syncs: (op, detail)
    widened_bf16: int           # bf16 -> fp32 conversions (CPU plain path)
    collectives: list           # collectives.record entries
    launches: dict              # ops.thread_launches() tally
    a_bytes: dict               # ops.thread_a_bytes() tally
    resident_bytes: int         # storages of the inputs
    peak_live_bytes: int        # resident + the step's own peak


def _tensors(x, depth: int = 0, seen=None):
    """The tensors reachable from ``x``: itself, the items of a tuple,
    list or dict, the fields of a dataclass, the attributes of an object
    (two levels: an operator's A and its sweep copy)."""
    seen = set() if seen is None else seen
    if id(x) in seen or depth > 3:
        return
    seen.add(id(x))
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v, depth + 1, seen)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v, depth + 1, seen)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name), depth + 1, seen)
    elif hasattr(x, "__dict__") and not isinstance(x, type) \
            and not callable(x) and depth < 2:
        for v in vars(x).values():
            yield from _tensors(v, depth + 1, seen)


def _storage_key(t: torch.Tensor):
    """(key, bytes) of the storage under ``t``, or None where it has no
    memory (meta and fake tensors)."""
    if t.device.type == "meta" or isinstance(
            t, torch._subclasses.fake_tensor.FakeTensor):
        return None
    st = t.untyped_storage()
    ptr = st.data_ptr()
    if ptr == 0:
        return None
    return (t.device.type, t.device.index, ptr), st.nbytes()


class _Live:
    """The storages live during a step: each op output's storage from its
    creation until the last tensor on it is freed (``weakref.finalize``),
    the inputs' for the whole step."""

    def __init__(self, inputs, device: str):
        self.device = device
        self.resident = {}
        for t in inputs:
            k = _storage_key(t)
            if k is not None and t.device.type == device:
                self.resident[k[0]] = k[1]
        self.base = sum(self.resident.values())
        self.live: dict = {}             # key -> [bytes, tensors on it]
        self.cur = self.peak = 0

    def add(self, t: torch.Tensor) -> None:
        import weakref
        k = _storage_key(t)
        if k is None or k[0] in self.resident or t.device.type != self.device:
            return
        key, nbytes = k
        entry = self.live.get(key)
        if entry is None:
            entry = self.live[key] = [nbytes, 0]
            self.cur += nbytes
            self.peak = max(self.peak, self.cur)
        entry[1] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key) -> None:
        entry = self.live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] <= 0:
            self.cur -= entry[0]
            del self.live[key]


def _flat(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _flat(v)


class _Recorder(TorchDispatchMode):
    def __init__(self, live: _Live):
        super().__init__()
        self.live = live
        self.dtypes: dict = {}
        self.products: list = []
        self.f64_ops: list = []
        self.syncs: list = []
        self.widened_bf16 = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        base = name.rstrip("_") or name
        ins = list(_flat(list(args) + list(kwargs.values())))
        outs = list(_flat(out))
        for t in outs:
            key = str(t.dtype)[6:]
            self.dtypes[key] = self.dtypes.get(key, 0) + 1
        if base in _PRODUCTS:
            self.products.append((base, [str(t.dtype)[6:] for t in ins],
                                  str(outs[0].dtype)[6:] if outs else None))
        if any(t.dtype == torch.float64 for t in ins + outs):
            self.f64_ops.append(base)
        if base in _SYNC_OPS:
            dev = ins[0].device.type if ins else "?"
            self.syncs.append((base, f"on {dev}"))
        elif base in ("copy", "_to_copy") and ins and outs:
            src = ins[1] if base == "copy" and len(ins) > 1 else ins[0]
            dst = outs[0]
            if src.dtype in _NARROW and dst.dtype == torch.float32:
                self.widened_bf16 += 1
            if (src.device.type == "cuda" and dst.device.type == "cpu"
                    and not kwargs.get("non_blocking", False)
                    and not (len(args) > 2 and args[2] is True)):
                self.syncs.append((base, "blocking copy from the card to "
                                         "the host"))
        for t in outs:
            self.live.add(t)
        return out


def trace_step(fn, *args, device=None) -> StepTrace:
    """Run ``fn(*args)`` once under the recorder.  The storages of the
    tensors reachable from ``args`` count as live from entry; only storages on the step's device count: ``device``, or by
    default the card where any input is on it (a step that fetches its
    operands itself names its device)."""
    from repro_torch.core import collectives
    from repro_torch.kernels import ops

    inputs = list(_tensors(args))
    dev = device or ("cuda" if any(t.device.type == "cuda" for t in inputs)
                     else "cpu")
    live = _Live(inputs, dev)
    n_coll = len(collectives.record)
    with ops.thread_launches() as launches, ops.thread_a_bytes() as a_bytes:
        rec = _Recorder(live)
        with rec:
            fn(*args)
        if dev == "cuda":
            torch.cuda.synchronize()
    coll = [dict(c) for c in collectives.record[n_coll:]]
    return StepTrace(
        device=dev, dtypes=rec.dtypes, products=rec.products,
        f64_ops=rec.f64_ops, syncs=rec.syncs, widened_bf16=rec.widened_bf16,
        collectives=coll, launches=dict(launches), a_bytes=dict(a_bytes),
        resident_bytes=live.base, peak_live_bytes=live.base + live.peak)


def collective_schedule(trace: StepTrace) -> list:
    """Ordered collectives of the step: op, shape, dtype, bytes."""
    return [{"op": c["op"], "shape": list(c["shape"]), "dtype": c["dtype"],
             "bytes": int(c["bytes"]), "group_size": int(c["group_size"])}
            for c in trace.collectives]


def _bf16_routes(launches: dict) -> int:
    return sum(c for key, c in launches.items()
               if key.endswith(("/wgmma", "/wgmma_ld", "/bfloat16")))


def _fp32_routes(launches: dict) -> int:
    return sum(c for key, c in launches.items()
               if key.endswith(("/tf32x3", "/tf32x3_cpasync", "/float32")))


def check_step(trace: StepTrace, contract: StepContract, tag: str,
               pass_name: str = "trace"):
    """Check one traced step against its contract.  Returns
    ``(violations, details)``: the violations (empty when clean) and the
    measured facts for the report."""
    violations = []
    reduces = []
    for c in trace.collectives:
        if c["op"] == "all_reduce":
            reduces.append(tuple(int(d) for d in c["shape"]))
        elif c["op"] not in contract.allowed_collectives:
            violations.append(Violation(
                pass_name, "stray-collective", tag,
                f"collective {c['op']!r} of shape {tuple(c['shape'])} is "
                f"not in the step's contract (allowed: all_reduce"
                + (f" + {sorted(contract.allowed_collectives)}"
                   if contract.allowed_collectives else "") + ")"))

    n_bf16_products = 0
    for op, ins, out in trace.products:
        if any(d in ("bfloat16", "float16") for d in ins):
            n_bf16_products += 1
            if out != "float32":
                violations.append(Violation(
                    pass_name, "bf16-accum", tag,
                    f"{op} of {ins} operands returns {out} — a narrow "
                    f"accumulation where the contract sums in fp32"))

    if contract.forbid_f64 and trace.f64_ops:
        violations.append(Violation(
            pass_name, "f64-upcast", tag,
            f"ops {sorted(set(trace.f64_ops))} touch a float64 tensor — a "
            f"silent f64 upcast in a step that contracts fp32/bf16"))

    for op, detail in trace.syncs:
        violations.append(Violation(
            pass_name, "host-sync", tag,
            f"aten.{op} ({detail}) waits for the card inside the step — "
            f"host syncs belong outside it, behind the driver's lagged "
            f"read (core/operator.py::host_sync_scalar)"))

    expected = sorted(tuple(s) for s in contract.all_reduce_payloads)
    actual = sorted(reduces)
    if len(reduces) != len(contract.all_reduce_payloads):
        violations.append(Violation(
            pass_name, "collective-count", tag,
            f"expected exactly {len(contract.all_reduce_payloads)} "
            f"all-reduce(s) a step, traced {len(reduces)} (payloads: "
            f"{actual})"))
    elif expected != actual:
        violations.append(Violation(
            pass_name, "collective-payload", tag,
            f"all-reduce payload shapes {actual} != contract {expected}"))

    bf16_launches = _bf16_routes(trace.launches)
    fp32_launches = _fp32_routes(trace.launches)
    on_card = trace.device == "cuda"
    if contract.requires_bf16:
        if on_card and (bf16_launches == 0 or fp32_launches):
            violations.append(Violation(
                pass_name, "bf16-not-applied", tag,
                f"config says sweep_dtype=bfloat16 but the step launched "
                f"{bf16_launches} sweeps on the bf16 routes and "
                f"{fp32_launches} on the fp32 ones "
                f"({ {k: c for k, c in trace.launches.items() if '/' in k} })"))
        elif not on_card and trace.widened_bf16 == 0:
            violations.append(Violation(
                pass_name, "bf16-not-applied", tag,
                "config says sweep_dtype=bfloat16 but the plain path read "
                "no bf16 operand (nothing rounded to bf16 was widened for "
                "an fp32 product): the narrow sweep silently fell back"))
    elif on_card and bf16_launches:
        violations.append(Violation(
            pass_name, "bf16-not-applied", tag,
            f"an fp32 step launched {bf16_launches} sweeps on the bf16 "
            f"routes: A was read narrower than the config says"))

    details = {
        "device": trace.device,
        "n_all_reduce": len(reduces),
        "all_reduce_payloads": [list(s) for s in reduces],
        "n_products": len(trace.products),
        "n_bf16_products": n_bf16_products,
        "n_bf16_widened": trace.widened_bf16,
        "host_syncs": [list(s) for s in trace.syncs],
        "dtypes": dict(sorted(trace.dtypes.items())),
        "launches": {k: c for k, c in sorted(trace.launches.items())},
        "collectives": collective_schedule(trace),
    }
    return violations, details
