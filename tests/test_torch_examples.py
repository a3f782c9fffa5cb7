"""The port's examples (``python -m repro_torch.examples.<name>``) run to a
clean exit on the CPU, each in a process of its own with a 120 s
timeout; each checks its own results and exits nonzero on a miss.  The
quickstart's sigmas match the JAX package's ``repro.core.svd`` on the
same matrix (rtol 2e-4) on the leg both packages converge: the block
method from the range-finder start.  On this nearly flat spectrum (gaps
of 0.4 %) the deflation legs and the capped block leg stop at
``max_iters`` unconverged, where two packages' different start vectors
leave different residual errors (the JAX package's own gram leg ends
2.6e-4 off the prescribed sigma); the example holds those to the
prescribed spectrum itself (1e-3).  Without a card and
without ``--device cpu`` every new entry point raises, naming the
missing device.
"""
import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("quickstart", "unified_api", "svd_service", "chaos_demo",
            "compress_model")


def _run(*args, timeout=120):
    # one thread: beside the suite's busy workers, an example's OpenMP
    # threads would spin against theirs
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, env=env, timeout=timeout)


@pytest.mark.parametrize("name", [n for n in EXAMPLES if n != "quickstart"])
def test_example_exits_zero_on_the_cpu(name):
    proc = _run(f"repro_torch.examples.{name}", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]


def test_resume_demo_across_two_processes(tmp_path):
    ck = str(tmp_path / "ck")
    first = _run("repro_torch.examples.unified_api", "--device", "cpu",
                 "--resume-demo", ck, "--max-iters", "3")
    assert first.returncode == 0, first.stdout + first.stderr
    assert "budget-capped" in first.stdout
    second = _run("repro_torch.examples.unified_api", "--device", "cpu",
                  "--resume-demo", ck)
    assert second.returncode == 0, second.stdout + second.stderr
    assert second.stdout.startswith("resumed: iterations 4..")
    assert "bitwise-identical" in second.stdout


def test_quickstart_exits_zero_with_the_jax_packages_sigmas():
    import jax.numpy as jnp
    from repro.core import SVDConfig, svd
    from repro_torch.examples.quickstart import K, matrix

    proc = _run("repro_torch.examples.quickstart", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])["quickstart"]
    A, _ = matrix()
    res = svd(jnp.asarray(A), K, config=SVDConfig(
        method="block", eps=1e-8, max_iters=300, warmup_q=1))
    assert bool(res.converged)
    np.testing.assert_allclose(got["block+warm"], np.asarray(res.S),
                               rtol=2e-4)


@pytest.mark.parametrize("module", [
    *(f"repro_torch.examples.{name}" for name in EXAMPLES),
    "repro_torch.analysis", "repro_torch.launch.svd_check"])
def test_entry_point_without_a_device_raises(module, monkeypatch):
    """Run as ``python -m <module>`` with no arguments (in this process:
    each resolves its device before any other work)."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    monkeypatch.setattr(sys, "argv", [module])
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        runpy.run_module(module, run_name="__main__", alter_sys=True)
