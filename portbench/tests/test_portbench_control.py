"""The lower-precision control comes out not correct where the program
holds: each cell at its own size on a card (``-m gpu``), one seed, through
``portbench/control.py``; without a card the test skips."""
import json
import subprocess
import sys

import pytest

from portbench import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit_the_program_holds(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, str(harness.HERE / "control.py"), "--workload",
         cell, "--seeds", "2718281829", "--seconds", "4"],
        capture_output=True, text=True, timeout=900, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    limits = harness.load_json(harness.HERE / "limits" / f"{cell}.json")
    assert all(line["program"][k] <= lim for k, lim in limits.items()
               if k in line["program"]), line
    assert any(line["control"][k] > lim for k, lim in limits.items()
               if k in line["control"]), line
