"""The control: the plain reference in TF32 in the program's place must
come out not correct.  TF32 exists on the card only, so this runs there
(python3 -m pytest bench_torch/tests/test_control.py) and skips on a host
without a GPU; each cell, one seed, a short window."""

import json
import subprocess
import sys

import pytest

from bench_torch.harness import ROOT, load_benchmark

CELLS = [w["name"] for w in load_benchmark()["workloads"] if w["chips"] == 1]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists on the GPU only")
    out = subprocess.run(
        [sys.executable, "-m", "bench_torch.run", "--workload", cell,
         "--seed", "424242", "--seconds", "5", "--trace", "0",
         "--control", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is False, res["checks"]
