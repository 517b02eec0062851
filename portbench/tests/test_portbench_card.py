"""On the card: a short run of every cell comes out correct, with the
contract's result line. Skips where there is no CUDA card."""
import json
import os
import subprocess
import sys

import pytest

import tiny
from portbench.harness import manifest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in manifest.benchmark()["workloads"]])
def test_cell_runs_correct_on_the_card(card, workload):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload, "--seed", "2147483999",
                          "--seconds", "5", "--trace", "0"], capture_output=True, text=True, cwd=tiny.REPO,
                         timeout=900, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert list(line)[-1] == "checks"
