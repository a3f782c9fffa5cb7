"""The port's paper-scale dry run (``python -m repro_torch.launch.svd_dryrun``)
on the CPU: fake tensors, a fake process group of world 256.

Each variant's traced collective schedule must be the JAX package's own
contract table (``repro.launch.svd_dryrun.variant_contract``, read in a
child process: importing that module appends
``--xla_force_host_platform_device_count`` to ``XLA_FLAGS``, which would
change JAX for every later test of this process), its psums read as
all-reduces; the products over an operand of the shard's size must count
their closed-form FLOPs; the bf16 twin must read half of fp32's bytes of
A with equal collective bytes.  A planted drift of the table makes the
run exit 1 with the expected-against-traced diff.  The dry run makes the
process's default process group, so it runs in a child process too.
"""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M_GLOBAL, N, K, ND = 262_144 * 32, 32_768, 32, 16
M_LOC = M_GLOBAL // (ND * ND)
L = K + 8

TAGS = ("chain/faithful", "chain/opt", "gram/faithful", "gram/opt",
        "block/opt", "block/bf16", "block/warm")

# The reference's table, as JSON: variant_contract reads only the mesh's
# "data" extent, so the child passes the production mesh's shape
# (repro/launch/mesh.py::make_production_mesh, 16 x 16) and not a mesh
# of 256 host devices
_READ_TABLE = f"""
import json, types
from repro.launch.svd_dryrun import variant_contract
mesh = types.SimpleNamespace(shape={{"data": {ND}, "model": {ND}}})
out = {{}}
for tag in {TAGS!r}:
    c = variant_contract(tag, mesh)
    out[tag] = {{"psum_payloads": [[list(s) for s in sig]
                                   for sig in c.psum_payloads],
                "allowed": sorted(c.allowed_collectives),
                "requires_bf16": c.requires_bf16}}
print(json.dumps(out))
"""

# the JAX name of a collective -> the port's (collectives.record's ``op``)
_PORT_NAME = {"psum_scatter": "reduce_scatter"}

SWEEP_FLOPS = {                 # 2 FLOPs a multiply-add, one rank's shard
    "chain/faithful": 3 * 2 * M_LOC * N,
    "chain/opt": 2 * 2 * M_LOC * N,
    # residual, Gram and B v (the replicated (n, n) B: the shard is square)
    "gram/faithful": 2 * M_LOC * N * K + 2 * M_LOC * N * N + 2 * N * N,
    "gram/opt": 2 * M_LOC * N * K + 2 * M_LOC * N * N,
    "block/opt": 4 * M_LOC * N * K,
    "block/bf16": 4 * M_LOC * N * K,
    "block/warm": 6 * M_LOC * N * L,
}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "svd_dryrun_torch.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.svd_dryrun", "--out",
         str(out)], capture_output=True, text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "fake process group of world 256" in proc.stdout
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def reference_table():
    proc = subprocess.run([sys.executable, "-c", _READ_TABLE],
                          capture_output=True, text=True, env=_env(),
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("tag", TAGS)
def test_schedule_is_the_reference_table(dryrun, reference_table, tag):
    rec, ref = dryrun["variants"][tag], reference_table[tag]
    # each of the reference's psums carries one operand: one all-reduce
    assert all(len(sig) == 1 for sig in ref["psum_payloads"])
    reduces = sorted(tuple(sig[0]) for sig in ref["psum_payloads"])
    assert sorted(tuple(s) for s in rec["all_reduce_payloads"]) == reduces
    others = {c["op"] for c in rec["collectives"]} - {"all_reduce"}
    allowed = {_PORT_NAME.get(op, op) for op in ref["allowed"]}
    assert others == allowed
    assert rec["ok"]


@pytest.mark.parametrize("tag", sorted(SWEEP_FLOPS))
def test_sweep_flops_equal_the_closed_form(dryrun, tag):
    rec = dryrun["variants"][tag]
    assert rec["sweep_flops"] == SWEEP_FLOPS[tag]
    assert rec["flops"] >= rec["sweep_flops"]
    assert rec["per_rank_shape"] == [M_LOC, N]


def test_bf16_twin_halves_a_bytes_and_keeps_collective_bytes(dryrun):
    fp32 = dryrun["variants"]["block/opt"]
    bf16 = dryrun["variants"]["block/bf16"]
    assert fp32["a_bytes"] == 2 * M_LOC * N * 4     # two sweeps of the shard
    assert bf16["a_bytes"] * 2 == fp32["a_bytes"]
    assert bf16["collective_bytes_total"] == fp32["collective_bytes_total"] \
        == N * K * 4
    assert bf16["n_bf16_widened"] > 0 and fp32["n_bf16_widened"] == 0


def test_a_drifted_table_exits_one_with_the_diff(tmp_path):
    code = (
        "import sys, repro_torch.launch.svd_dryrun as d\n"
        "from repro_torch.analysis.trace_check import StepContract\n"
        "real = d.variant_contract\n"
        "d.variant_contract = lambda tag: (StepContract("
        "all_reduce_payloads=((d.N,),)) if tag == 'chain/opt' "
        "else real(tag))\n"
        f"sys.exit(d.main(['--out', {str(tmp_path / 'x.json')!r}]))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=_env(), timeout=300)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "[FAIL] chain/opt" in proc.stdout
    assert "expected all-reduces: [[32768]]" in proc.stdout
    assert "traced   all-reduces: [[32800]]" in proc.stdout
