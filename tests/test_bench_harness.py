"""The bench harness itself must run anywhere: on a plain CPU env it must
print its one JSON line with a deterministic checksum and name the device it
ran on."""

import json
import os
import subprocess
import sys

import pytest


@pytest.mark.parametrize(
    "variant,extra",
    [
        ("segmenting", {}),
        ("merging_nan10", {"BENCH_MERGING": "1", "BENCH_NANFRAC": "0.1"}),
    ],
)
def test_bench_runs_on_cpu(variant, extra):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", **extra)
    env["BENCH_SIZE"] = "96"
    env["BENCH_LEVELS"] = "31"
    env["BENCH_INNER"] = "2"
    env["BENCH_REPS"] = "1"
    proc = subprocess.run(
        [sys.executable, os.path.join(repo, "bench.py")],
        env=env,
        cwd=repo,
        capture_output=True,
        text=True,
        timeout=420,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = proc.stdout.strip().splitlines()[-1]
    rec = json.loads(line)
    assert rec["metric"] == f"{variant}_96x96_u8_throughput"
    assert rec["unit"] == "Mpix/s"
    assert rec["value"] > 0 and rec["vs_baseline"] > 0
    assert rec["device"]["platform"] == "cpu" and rec["device"]["count"] >= 1


def test_graft_entry_compiles_and_runs():
    """__graft_entry__.entry() is the single-device compile check: its
    jitted end-to-end program must run and return a label image."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import __graft_entry__
    finally:
        sys.path.remove(repo)
    fn, args = __graft_entry__.entry()
    out = fn(*args)
    assert out.shape == args[0].shape and str(out.dtype) == "int32"
    assert int(out.max()) > 0
