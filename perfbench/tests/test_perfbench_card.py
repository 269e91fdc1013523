"""On the card: one short run of each cell through the command line, its
result line read as the driver reads it; and the faults of
test_perfbench_faults planted at each cell's own size."""

import json
import subprocess
import sys

import pytest

from cudapathtracer_tpu_torch.driver import Renderer
from pb import cell, spec
from test_perfbench_faults import _broken

WORKLOADS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_correct(card, workload):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 101), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=360, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"msamples_per_s", "setup_s"}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["unchanged", "half"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_fault_at_cell_size_is_not_correct(card, monkeypatch, workload,
                                           kind):
    """A whole run of the cell at its own frame, on the card, with the
    timed path broken underneath; prints the compared numbers."""
    monkeypatch.setattr(Renderer, "render_batch", _broken(kind))
    res = cell.run(workload, 2 ** 31 + 131, 1.0, device="cuda")
    print(f"fault {workload} {kind} checks {res['checks']}")
    assert not res["correct"]
    assert res["checks"]["px_off"][0] > res["checks"]["px_off"][1]
