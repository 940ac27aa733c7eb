"""The port's launcher (automatic_speech_recognition_torch/parallel/
launch.py): two CPU gloo ranks of tests/torch_launch_rank.py, one of
which fails; the launcher exits with that rank's code (128 + 9 = 137 for
a SIGKILL), where torchrun exits 1 (tests/test_torch_platform.py runs
the port's train under it the same way); and the port's supervisor
(tools/train_supervised.sh, its backoff sleep removed) retries an 18 from
a two-rank launch once and stops on a 1."""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import os
import subprocess
import sys

import pytest

from test_torch_platform import SUPERVISOR, REPO

RANK = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "torch_launch_rank.py")
LAUNCH = [sys.executable, "-m",
          "automatic_speech_recognition_torch.parallel.launch",
          "--nproc_per_node", "2", "--monitor_interval", "0.1", RANK]
ENV = {**os.environ,
       "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}


def _launch(*args, cmd=LAUNCH):
    return subprocess.run(cmd + list(args), env=ENV, capture_output=True,
                          text=True, timeout=120)


@pytest.mark.parametrize("how,code", [("18", 18), ("17", 17), ("20", 20),
                                      ("1", 1), ("kill", 137), ("ok", 0)])
def test_the_first_failing_ranks_code_is_the_launchers(how, code):
    r = _launch(how)
    assert r.returncode == code, r.stderr[-3000:]
    if code:
        # torchrun's report names rank 1 as the root cause
        assert "rank      : 1 (local_rank: 1)" in r.stderr, r.stderr[-3000:]


def test_supervisor_retries_an_18_from_two_ranks_and_stops_on_a_1(tmp_path):
    fast = tmp_path / "fast.sh"
    subprocess.run(["bash", "-c", f"sed 's/sleep \"$backoff\"/:/' "
                    f"{SUPERVISOR} > {fast}"], check=True)
    marker = tmp_path / "failed_once"
    r = subprocess.run(["bash", str(fast), "3", "--"] + LAUNCH
                       + ["18", str(marker)], env=ENV, capture_output=True,
                       text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    assert marker.exists()
    assert r.stderr.count("attempt ") == 2
    assert "transient platform failure (rc 18)" in r.stderr
    assert "[train_supervised] done" in r.stderr
    r = subprocess.run(["bash", str(fast), "3", "--"] + LAUNCH + ["1"],
                       env=ENV, capture_output=True, text=True, timeout=240)
    assert r.returncode == 1
    assert r.stderr.count("attempt ") == 1
    assert "non-retryable exit 1; stopping" in r.stderr
