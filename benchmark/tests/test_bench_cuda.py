"""The command on the card: each cell end to end for a few seconds, a
result line with `correct` true (run on the card; skipped here)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness as H

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  H.bench_spec()["workloads"]])
def test_cell_runs_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 19), "--seconds", "5", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, out.stderr[-2000:]
    assert result["device"]["platform"] == "gpu"
