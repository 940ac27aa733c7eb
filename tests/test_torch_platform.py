"""The port's exit-code contract: utils/platform.exit_for_transient_errors
(exit 18 on a dead platform), the entry points that wrap their main in
it, a transient failure on one of two torchrun ranks under the port's
launcher (exit 18), and the port's
supervisor tools/train_supervised.sh (retry 17, 18 and 137, stop on
anything else), mirroring tests/test_aux_subsystems.py's checks of the
JAX package's."""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import os
import re
import runpy
import subprocess
import sys

import numpy as np
import pytest

from automatic_speech_recognition_torch.utils import device as device_lib
from automatic_speech_recognition_torch.utils.platform import (
    _TRANSIENT_MARKERS, TRANSIENT_EXIT_CODE, exit_for_transient_errors,
    is_transient_platform_error)

from test_torch_train_cli import _args as cli_args
from test_torch_train_cli import _shards as cli_shards

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUPERVISOR = os.path.join(REPO, "automatic_speech_recognition_torch",
                          "tools", "train_supervised.sh")
# every port entry point whose __main__ is wrapped, as the root scripts'
WRAPPED = ("train", "test", "decode", "preprocess", "train_lm", "sample_lm",
           "transcribe", "import_checkpoint")


def _raise(exc):
    def main(argv=None):
        raise exc
    return main


@pytest.mark.parametrize("marker", _TRANSIENT_MARKERS)
def test_each_marker_exits_18(marker):
    with pytest.raises(SystemExit) as e:
        exit_for_transient_errors(_raise(RuntimeError(f"x {marker} y")))
    assert e.value.code == TRANSIENT_EXIT_CODE == 18


def test_a_wrapped_cause_exits_18_and_a_bug_propagates():
    try:
        try:
            raise ConnectionError("Connection reset by peer")
        except ConnectionError as inner:
            raise RuntimeError("rendezvous failed") from inner
    except RuntimeError as outer:
        wrapped = outer
    assert is_transient_platform_error(wrapped)
    with pytest.raises(SystemExit) as e:
        exit_for_transient_errors(_raise(wrapped))
    assert e.value.code == 18
    with pytest.raises(ValueError, match="bug"):
        exit_for_transient_errors(_raise(ValueError("bug")))
    assert exit_for_transient_errors(lambda argv: 7) == 7


@pytest.mark.filterwarnings("ignore::RuntimeWarning")   # runpy, re-import
@pytest.mark.parametrize("name", WRAPPED)
def test_entry_point_main_exits_18_on_a_transient_error(name, monkeypatch):
    """The module run as __main__ (python -m), with the first thing every
    main calls failing as a dead gloo transport does."""
    monkeypatch.setattr(device_lib, "split_device", _raise(RuntimeError(
        "[gloo/transport/tcp/pair.cc:534] Connection reset by peer")))
    monkeypatch.setattr(sys, "argv", [name])
    with pytest.raises(SystemExit) as e:
        runpy.run_module(f"automatic_speech_recognition_torch.{name}",
                         run_name="__main__")
    assert e.value.code == 18
    # a genuine error is not turned into a retry
    monkeypatch.setattr(device_lib, "split_device",
                        _raise(ValueError("bad flag")))
    with pytest.raises(ValueError, match="bad flag"):
        runpy.run_module(f"automatic_speech_recognition_torch.{name}",
                         run_name="__main__")


# rank 1 loses its transport at the first logging step's flag exchange
_INJECT = r"""
import os, runpy, sys
from automatic_speech_recognition_torch.parallel import distributed
if os.environ["RANK"] == "1":
    def lost(*args, **kwargs):
        raise RuntimeError("[gloo/transport/tcp/pair.cc:534] Connection "
                           "reset by peer")
    distributed.any_flag = lost
sys.argv = ["train"] + sys.argv[1:]
runpy.run_module("automatic_speech_recognition_torch.train",
                 run_name="__main__", alter_sys=True)
"""


def test_transient_error_on_one_torchrun_rank_ends_every_rank(tmp_path):
    """Rank 1 exits 18; rank 0, blocked in the collective, is stopped by
    torchrun's agent, which raises ChildFailedError (torchrun itself
    would exit 1 whatever the worker's code); the port's launcher
    (parallel/launch.py), which run.sh's train stage uses, exits with
    the first failing rank's 18, so a supervisor retries it."""
    d = str(tmp_path)
    cli_shards(d, np.random.default_rng(0))
    (tmp_path / "inject.py").write_text(_INJECT)
    env = {**os.environ,
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run(
        [sys.executable, "-m",
         "automatic_speech_recognition_torch.parallel.launch",
         "--nproc_per_node", "2", str(tmp_path / "inject.py")]
        + cli_args(d) + ["--epoch", "1", "--steps_per_epoch", "30"],
        cwd=d, env=env, capture_output=True, text=True, timeout=240)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 18, out[-4000:]
    assert "transient platform failure" in out
    assert re.search(r"rank\s*: 1 \(local_rank: 1\)\s*\n\s*exitcode\s*: 18",
                     out), out[-4000:]
    pids = {int(p) for p in re.findall(r"\(pid: (\d+)\)", out)}
    assert len(pids) == 2, out[-4000:]
    for pid in pids:                       # every rank is gone
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    assert not os.path.exists(os.path.join(d, "model", "1.pt"))


# ------------------------------------------------------------ supervisor


@pytest.fixture
def fast_supervisor(tmp_path):
    """The supervisor with its backoff sleep removed, as
    tests/test_aux_subsystems.py runs the JAX script."""
    fast = tmp_path / "fast.sh"
    subprocess.run(["bash", "-c", f"sed 's/sleep \"$backoff\"/:/' "
                    f"{SUPERVISOR} > {fast}"], check=True)
    assert "sleep" not in "".join(l for l in fast.read_text().splitlines()
                                  if not l.lstrip().startswith(("#", "echo")))
    return fast


def _worker(tmp_path, codes):
    """A worker that exits codes[n] on its n-th run (a SIGKILL for 137),
    then 0; the runs are counted in a file."""
    cnt = tmp_path / "count"
    table = " ".join(str(c) for c in codes)
    w = tmp_path / "worker.sh"
    w.write_text(
        "#!/bin/bash\n"
        f"n=$(cat {cnt} 2>/dev/null || echo 0); echo $((n+1)) > {cnt}\n"
        f"codes=({table})\n"
        "c=${codes[$n]:-0}\n"
        "[ \"$c\" = 137 ] && kill -KILL $$\n"
        "exit $c\n")
    w.chmod(0o755)
    return w, cnt


@pytest.mark.parametrize("code", [17, 18, 137])
def test_supervisor_retries_17_18_and_137(tmp_path, fast_supervisor, code):
    worker, cnt = _worker(tmp_path, [code, code])
    r = subprocess.run(["bash", str(fast_supervisor), "5", "--",
                        str(worker)], capture_output=True, text=True,
                       timeout=60)
    assert r.returncode == 0, r.stderr
    assert cnt.read_text().strip() == "3"
    assert r.stderr.count("sleeping") == 2 and "done" in r.stderr


@pytest.mark.parametrize("code", [20, 1, 21])
def test_supervisor_stops_on_any_other_code(tmp_path, fast_supervisor, code):
    """20 (diverged) and 1 (a bug) stop at once; so does 21, the JAX
    script's planned recycle, which nothing in the port exits."""
    worker, cnt = _worker(tmp_path, [code])
    r = subprocess.run(["bash", str(fast_supervisor), "5", "--",
                        str(worker)], capture_output=True, text=True,
                       timeout=60)
    assert r.returncode == code
    assert cnt.read_text().strip() == "1"
    assert f"non-retryable exit {code}; stopping" in r.stderr


def test_supervisor_passes_success_through_and_gives_up_with_19(
        tmp_path, fast_supervisor):
    worker, cnt = _worker(tmp_path, [])
    r = subprocess.run(["bash", str(fast_supervisor), "--", str(worker)],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0 and cnt.read_text().strip() == "1"
    assert "attempt 1/24" in r.stderr
    cnt.unlink()
    worker, cnt = _worker(tmp_path, [18] * 5)
    r = subprocess.run(["bash", str(fast_supervisor), "3", "--",
                        str(worker)], capture_output=True, text=True,
                       timeout=60)
    assert r.returncode == 19 and cnt.read_text().strip() == "3"
    assert "gave up after 3 attempts" in r.stderr
    r = subprocess.run(["bash", str(fast_supervisor)], capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 2 and "usage" in r.stderr


def test_supervisor_keeps_the_jax_scripts_contract():
    """The retry codes, messages, backoff and exhaustion code of
    tools/train_supervised.sh, without its recycle branch."""
    port = open(SUPERVISOR).read()
    jax_script = open(os.path.join(REPO, "tools", "train_supervised.sh")
                      ).read()
    code = lambda s: [l.strip() for l in s.splitlines()
                      if l.strip() and not l.strip().startswith("#")]
    recycle = [l for l in code(jax_script) if "21" in l or "planned" in l
               or l in ("sleep 2", "continue ;;   # no attempt consumed, "
                        "no backoff")]
    assert [l for l in code(jax_script) if l not in recycle] == code(port)
