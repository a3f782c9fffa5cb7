"""Repo lint pass: the solver conventions stdlib ``ast`` can enforce.

Five rules over ``src/repro_torch/core`` (the driver and the backends:
host-side code the trace pass sees only through what it runs), the JAX
package's ``repro/analysis/lint.py`` read for PyTorch:

* **ANA001 host-sync-in-loop** — ``float()``/``bool()``/``.item()``/
  ``.tolist()``/``.cpu()``/``np.asarray()``/``torch.cuda.synchronize()``
  inside a loop body waits for the card once an iteration.  The ONE
  sanctioned device->host sync is ``core/operator.py::host_sync_scalar``
  (the driver's lagged convergence read); everything else is hoisted out
  of the loop or an allowlisted exception.  ``sparse.py`` packs its
  stream with numpy on the host, so ``np.asarray`` there is array
  plumbing, not a sync.
* **ANA002 frozen-state-mutation** — ``SolverState`` is an immutable
  value (checkpointing and bitwise resume depend on it); assigning to
  its attributes, or ``object.__setattr__`` on anything but ``self``, is
  forbidden.
* **ANA003 raw-generator** — seeds cross process and checkpoint
  boundaries as integers, and a generator is made from one only by
  ``core/tsvd.py::seeded_generator``; a ``torch.Generator``,
  ``manual_seed`` or ``torch.random`` seed anywhere else forks the seed
  convention.
* **ANA004 accounting-bypass** — ``passes``/``bytes_moved`` on the
  state flow ONLY through ``core/svd.py::_stamp``; a
  ``.replace(passes=...)`` anywhere else double-counts or drops a delta.
* **ANA005 uncached-compile** — ``torch.compile``/``torch.jit`` called
  inside a function body builds a new compiled callable a call: a
  silent recompile in a hot loop.  Compiled steps live at module level
  or behind ``functools.lru_cache`` builders.

Pure stdlib (``ast``): it imports no torch.
"""
from __future__ import annotations

import ast
import os

from repro_torch.analysis.report import Violation

__all__ = ["lint_file", "lint_tree", "lint_core", "DEFAULT_LINT_ROOT"]

DEFAULT_LINT_ROOT = os.path.join(os.path.dirname(__file__), "..", "core")

#: functions whose bodies are the sanctioned host-sync implementations
SANCTIONED_SYNC_FUNCS = {"host_sync_scalar"}

#: the one place a generator is seeded (``file::function``)
SEED_HELPER = ("tsvd.py", "seeded_generator")

#: files whose streamed backends pack on the host with numpy:
#: np.asarray there is array plumbing, not a device sync (float()/
#: .item() in loops are still flagged)
NUMPY_HOST_FILES = {"sparse.py"}

_SYNC_CALLS = {"float", "bool"}
_SYNC_METHODS = {"item", "tolist", "cpu"}
_SYNC_ATTR_CALLS = {("np", "asarray"), ("numpy", "asarray"),
                    ("torch", "cuda", "synchronize")}
_SEED_CALLS = {("torch", "Generator"), ("torch", "manual_seed"),
               ("torch", "random", "manual_seed"), ("torch", "random", "seed"),
               ("torch", "seed"), ("torch", "cuda", "manual_seed"),
               ("torch", "cuda", "manual_seed_all")}


def _attr_chain(node):
    """('torch','cuda','synchronize') for torch.cuda.synchronize, else ()."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return tuple(reversed(parts))


def _decorator_names(node):
    names = []
    for d in node.decorator_list:
        t = d.func if isinstance(d, ast.Call) else d
        names.append(".".join(_attr_chain(t)) or "")
    return names


class _Linter(ast.NodeVisitor):
    def __init__(self, relpath: str):
        self.relpath = relpath
        self.fname = os.path.basename(relpath)
        self.violations: list[Violation] = []
        self.scope: list[str] = []          # qualname parts
        self.loop_depth: list[int] = [0]    # one counter per function frame
        self.cached_fn: list[bool] = [False]
        self.state_params: list[set] = [set()]

    def _qualname(self) -> str:
        return ".".join(self.scope) or "<module>"

    def _report(self, rule: str, node, msg: str):
        self.violations.append(Violation(
            "lint", rule, f"{self.relpath}::{self._qualname()}",
            f"line {node.lineno}: {msg}"))

    def _in_function(self) -> bool:
        return len(self.loop_depth) > 1

    def _in_loop(self) -> bool:
        return self.loop_depth[-1] > 0

    def visit_ClassDef(self, node):
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    def _visit_func(self, node):
        decos = _decorator_names(node)
        cached = any("lru_cache" in d or d.endswith(".cache")
                     or d == "cache" for d in decos)
        stateish = {a.arg for a in
                    list(node.args.args) + list(node.args.kwonlyargs)
                    if a.annotation is not None
                    and "SolverState" in ast.unparse(a.annotation)}
        stateish |= {a.arg for a in node.args.args if a.arg == "state"}
        self.scope.append(node.name)
        self.loop_depth.append(0)
        self.cached_fn.append(cached or self.cached_fn[-1])
        self.state_params.append(stateish)
        self.generic_visit(node)
        self.state_params.pop()
        self.cached_fn.pop()
        self.loop_depth.pop()
        self.scope.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def _visit_loop(self, node):
        self.loop_depth[-1] += 1
        self.generic_visit(node)
        self.loop_depth[-1] -= 1

    visit_For = _visit_loop
    visit_While = _visit_loop
    visit_AsyncFor = _visit_loop

    def visit_Call(self, node):
        chain = _attr_chain(node.func)
        dotted = ".".join(chain)

        # ANA001: host syncs inside loop bodies
        if self._in_loop() and not set(self.scope) & SANCTIONED_SYNC_FUNCS:
            hit = None
            if len(chain) == 1 and chain[0] in _SYNC_CALLS:
                hit = chain[0] + "()"
            elif chain in _SYNC_ATTR_CALLS:
                if not (self.fname in NUMPY_HOST_FILES
                        and chain[-1] == "asarray"):
                    hit = dotted + "()"
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _SYNC_METHODS and not node.args:
                hit = f".{node.func.attr}()"
            if hit:
                self._report(
                    "ANA001", node,
                    f"{hit} inside a loop body is a per-iteration host "
                    f"sync that stalls the card's queue; route it through "
                    f"core/operator.py::host_sync_scalar (lagged) or "
                    f"hoist it out of the loop")

        # ANA002: object.__setattr__ on non-self
        if chain[-2:] == ("object", "__setattr__"):
            if node.args and not (isinstance(node.args[0], ast.Name)
                                  and node.args[0].id == "self"):
                self._report(
                    "ANA002", node,
                    "object.__setattr__ on a non-self target mutates a "
                    "frozen value in place; build a new state with "
                    ".replace(...) instead")

        # ANA003: a generator seeded outside the seed convention's helper
        seeded_here = (self.fname, SEED_HELPER[1]) == SEED_HELPER \
            and SEED_HELPER[1] in self.scope
        if not seeded_here and (
                chain in _SEED_CALLS or chain[-1:] == ("Generator",)
                or (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "manual_seed")):
            self._report(
                "ANA003", node,
                f"{dotted or node.func.attr}() outside "
                f"core/tsvd.py::seeded_generator forks the seed "
                f"convention; derive generators from the integer seed "
                f"there")

        # ANA004: accounting fields set outside the _stamp helper
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr == "replace" \
                and "_stamp" not in self.scope:
            bad = {k.arg for k in node.keywords} & {"passes", "bytes_moved"}
            if bad:
                self._report(
                    "ANA004", node,
                    f".replace({', '.join(sorted(bad))}=...) bypasses the "
                    f"delta-stamped accounting; go through "
                    f"core/svd.py::_stamp")

        # ANA005: torch.compile / torch.jit inside a function body
        if (chain[:2] == ("torch", "compile") or chain[:2] == ("torch", "jit")
                ) and self._in_function() and not self.cached_fn[-1]:
            self._report(
                "ANA005", node,
                f"{dotted}(...) inside a function body builds a new "
                f"compiled callable a call; hoist it to module level or "
                f"an @functools.lru_cache builder")

        self.generic_visit(node)

    def visit_Assign(self, node):
        for t in node.targets:
            if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
                    and t.value.id in self.state_params[-1]:
                self._report(
                    "ANA002", node,
                    f"assignment to {t.value.id}.{t.attr} mutates the "
                    f"frozen SolverState; use state.replace(...)")
        self.generic_visit(node)


def lint_tree(tree: ast.AST, relpath: str) -> list:
    linter = _Linter(relpath)
    linter.visit(tree)
    return linter.violations


def lint_file(path: str, relpath: str | None = None) -> list:
    with open(path, encoding="utf-8") as f:
        src = f.read()
    rel = relpath or os.path.basename(path)
    return lint_tree(ast.parse(src, filename=path), rel)


def lint_core(root: str | None = None) -> list:
    """Lint every module of ``src/repro_torch/core`` (the default root)."""
    root = os.path.abspath(root or DEFAULT_LINT_ROOT)
    out = []
    for name in sorted(os.listdir(root)):
        if name.endswith(".py"):
            out.extend(lint_file(os.path.join(root, name),
                                 relpath=f"core/{name}"))
    return out
