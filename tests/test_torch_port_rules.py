"""Rules the PyTorch port keeps, checked on the source and on behaviour.

* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports JAX
  or the JAX package ``repro`` (the port runs where JAX is absent).
* Entry points run on the card unless the caller asks for the CPU:
  without a CUDA device and without ``device=`` they raise.
* The CUDA kernels build into a directory git ignores.
"""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.operator import DenseOperator, resolve_device
from repro_torch.kernels import build

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    return any(name == root or name.startswith(root + ".")
               for root in ("jax", "jaxlib", "repro"))


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_or_repro(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_rule_catches_the_jax_package():
    assert _forbidden("jax.numpy") and _forbidden("repro.core.svd")
    assert not _forbidden("repro_torch.core") and not _forbidden("jaxtyping")


def test_port_imports_with_jax_unavailable():
    """Importing the whole port with jax and repro blocked succeeds."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch, repro_torch.kernels.build, "
            "repro_torch.kernels.block_matvec; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid")


def test_svd_without_device_raises_when_no_card():
    _no_card()
    A = torch.from_numpy(np.eye(6, 4, dtype=np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.svd(A, 2)
    assert repro_torch.svd(A, 2, device="cpu").S.shape == (2,)


def test_dense_operator_without_device_raises_when_no_card():
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DenseOperator(torch.ones(5, 3))
    with pytest.raises(RuntimeError):
        resolve_device(None)


def test_devices_other_than_cpu_and_cuda_are_refused():
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_kernel_build_directory_is_ignored_by_git():
    ignored = (ROOT / ".gitignore").read_text().split()
    rel = build.BUILD_DIR.relative_to(ROOT).as_posix() + "/"
    assert rel in ignored
    assert build.CSRC.joinpath("block_matvec.cu").exists()
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
