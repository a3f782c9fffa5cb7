"""Rules the PyTorch port keeps, checked on the source and on behaviour.

* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports JAX
  or the JAX package ``repro`` (the port runs where JAX is absent).
* Entry points run on the card unless the caller asks for the CPU:
  without a CUDA device and without ``device=`` (``--device`` for
  ``python -m repro_torch.launch.serve`` and ``launch.train``) they
  raise (training's ``init_train_state`` and ``TrainingRunner`` too); that holds for the
  out-of-core tiers' inputs (numpy arrays, ``.npy`` paths, memmaps) and
  matrices too, and for the sparse stream's (synthetic streams, scipy
  matrices, ``.npz`` paths).
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
from repro_torch.core import HostBlockedMatrix, MemmapMatrix
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
            "repro_torch.kernels.block_matvec, "
            "repro_torch.kernels.deflate_matvec, repro_torch.kernels.gram, "
            "repro_torch.kernels.local_attn, repro_torch.kernels.recurrent, "
            "repro_torch.core.partition, "
            "repro_torch.core.staging, repro_torch.core.oom, "
            "repro_torch.core.diskio, repro_torch.core.sparse, "
            "repro_torch.kernels.csr_sweep, repro_torch.checkpoint, "
            "repro_torch.configs, repro_torch.models.config, "
            "repro_torch.models.layers, repro_torch.models.mlp, "
            "repro_torch.models.recurrent, "
            "repro_torch.models.transformer, repro_torch.models.convert, "
            "repro_torch.launch.serve, repro_torch.data, "
            "repro_torch.optim.adamw, repro_torch.optim.compression, "
            "repro_torch.training, repro_torch.training.runner, "
            "repro_torch.launch.train; "
            "import repro_torch.configs as c; "
            "[c.get_config(a) for a in c.list_archs()]; print('ok')")
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


def test_numpy_svd_without_device_raises_when_no_card(tmp_path):
    """The out-of-core tiers run on the card too: a numpy array, a .npy
    path or an np.memmap given no device raises; ``device="cpu"`` runs."""
    _no_card()
    A = np.eye(6, 4, dtype=np.float32)
    path = str(tmp_path / "A.npy")
    np.save(path, A)
    for src in (A, path, np.load(path, mmap_mode="r")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            repro_torch.svd(src, 2)
        assert repro_torch.svd(src, 2, device="cpu").S.shape == (2,)


def test_sparse_svd_without_device_raises_when_no_card(tmp_path):
    """The sparse stream runs on the card too: a synthetic stream, a
    scipy matrix or a ``.npz`` path given no device raises; its streamed
    ops given numpy and no device raise; ``device="cpu"`` runs."""
    _no_card()
    import scipy.sparse
    from repro_torch.core import SyntheticSparseMatrix
    sp = SyntheticSparseMatrix(64, 12, 3, seed=0)
    csr = scipy.sparse.random(40, 12, density=0.3, random_state=0,
                              format="csr")
    path = str(tmp_path / "A.npz")
    scipy.sparse.save_npz(path, csr)
    for src in (sp, csr, path):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            repro_torch.svd(src, 2)
        assert repro_torch.svd(src, 2, device="cpu").S.shape == (2,)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sp.matmat(np.ones((12, 2), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.svd(sp, 2, method="gramfree")


def test_host_blocked_matrix_without_device_raises_when_no_card(tmp_path):
    _no_card()
    A = np.ones((8, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HostBlockedMatrix(A, 2)
    np.save(tmp_path / "A.npy", A)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MemmapMatrix(str(tmp_path / "A.npy"), 2)
    assert HostBlockedMatrix(A, 2, device="cpu").device.type == "cpu"


def test_serve_without_device_raises_when_no_card():
    _no_card()
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    argv = ["--arch", "gemma2-9b", "--smoke", "--batch", "1",
            "--prompt-len", "4", "--tokens", "1"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(argv)
    cfg = smoke_config(get_config("gemma2-9b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_cache(cfg, 1, 8)
    assert serve.main(argv + ["--device", "cpu"])["tokens"].shape == (1, 1)


def test_training_without_device_raises_when_no_card(tmp_path):
    """Training's entry points run on the card too: ``init_train_state``,
    ``TrainingRunner`` and ``python -m repro_torch.launch.train`` given no
    device raise; ``device="cpu"`` (``--device cpu``) trains."""
    _no_card()
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.launch import train
    from repro_torch.training import TrainConfig, init_train_state
    from repro_torch.training.runner import RunnerConfig, TrainingRunner
    cfg = smoke_config(get_config("qwen3-0.6b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(cfg, TrainConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainingRunner(cfg, TrainConfig(), RunnerConfig(
            ckpt_dir=str(tmp_path / "r")), DataConfig(cfg.vocab_size, 8, 2))
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--steps", "1", "--batch",
            "2", "--seq", "8", "--ckpt-dir", str(tmp_path / "c")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(argv)
    assert len(train.main(argv + ["--device", "cpu"])["losses"]) == 1


def test_devices_other_than_cpu_and_cuda_are_refused():
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_kernel_build_directory_is_ignored_by_git():
    ignored = (ROOT / ".gitignore").read_text().split()
    rel = build.BUILD_DIR.relative_to(ROOT).as_posix() + "/"
    assert rel in ignored
    for name in ("block_matvec_tc", "block_matvec_tf32", "csr_sweep",
                 "deflate_matvec", "gram_bf16", "gram_tf32", "local_attn",
                 "staging"):
        assert build.CSRC.joinpath(f"{name}.cu").exists()
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
