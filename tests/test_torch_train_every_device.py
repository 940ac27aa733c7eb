"""`train` over every device --device names, from one command
(automatic_speech_recognition_torch/train.py with parallel/launch.py), as
the JAX package's train.py builds its mesh over every local device.

On the CPU, `--device cpu,cpu` is two gloo ranks started by train itself.
Held here: train.main over cpu,cpu equals `parallel.launch
--nproc_per_node 2` on the same flags, step by step and in the final
parameters, data-parallel and at --num_partitions 2 (bit-equal: the same
two ranks run the same program); the CLI's exit code is the first
failing rank's (tests/torch_launch_rank.py's ending, injected on rank 1
of train through a sitecustomize); under torchrun's environment nothing
is launched again; a --num_partitions that does not divide the devices
raises; a list of GPUs reaches the ranks as CUDA_VISIBLE_DEVICES, each
rank pinned to cuda:LOCAL_RANK of it."""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import json
import os
import subprocess
import sys

import pytest
import torch

from automatic_speech_recognition_torch import train as train_cli
from automatic_speech_recognition_torch.parallel import distributed, launch
from automatic_speech_recognition_torch.training.checkpoint import (
    CheckpointManager)

from test_torch_train_cli import _args as cli_args
from test_torch_train_cli import _shards as cli_shards

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
TIMEOUT = 240
TWO_STEPS = ["--epoch", "1", "--steps_per_epoch", "2"]
# rank 1 of train ends as RANK_FAULT says at its first flag exchange (the
# first logging step); rank 0 sleeps there until torchrun's SIGTERM ends
# it (with the default action: train's handler would defer it to the next
# logging step, and torchrun would wait 30 s before its SIGKILL)
_SITE = f"""
import os, signal, sys
if "RANK" in os.environ and os.environ.get("RANK_FAULT"):
    sys.path.insert(0, {TESTS!r})
    from torch_launch_rank import end
    from automatic_speech_recognition_torch.parallel import distributed

    def fault(*args, **kwargs):
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        end(os.environ["RANK_FAULT"], int(os.environ["RANK"]))

    distributed.any_flag = fault
"""


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    import numpy as np
    d = str(tmp_path_factory.mktemp("every_device"))
    cli_shards(d, np.random.default_rng(0))
    return d


def _flags(d, run, *extra):
    """The train CLI test's flags without --device, into run's own
    directories."""
    args = cli_args(d)[2:]
    args[args.index("--save_dir") + 1] = f"{d}/{run}/model"
    args[args.index("--summary_dir") + 1] = f"{d}/{run}/summary"
    return args + TWO_STEPS + list(extra)


def _env(**extra):
    path = os.environ.get("PYTHONPATH")
    return {**os.environ,
            "PYTHONPATH": REPO + (os.pathsep + path if path else ""),
            **extra}


@pytest.mark.parametrize("extra", [[], ["--num_partitions", "2"]],
                         ids=["dp2", "tp2"])
def test_one_command_trains_as_the_launchers_two_ranks(shard_dir, extra):
    """train.main(--device cpu,cpu) starts two gloo ranks itself and
    returns rank 0's history and the state of the run's last checkpoint;
    `parallel.launch --nproc_per_node 2 -m train --device cpu`, run
    beside it on the same flags, gives the same losses and gradient norms
    at every step and the same parameters and step (bit-equal)."""
    d = shard_dir
    run = "tp" if extra else "dp"
    history = f"{d}/{run}_launcher_history.json"
    ranks = launch.Ranks(2, "cpu", {})
    proc = subprocess.Popen(
        launch.launcher_command(ranks, train_cli.MODULE,
                                _flags(d, f"{run}_launcher", *extra)),
        env=_env(**{train_cli.HISTORY_ENV: history}),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ts, hist = train_cli.main(["--device", "cpu,cpu"]
                                  + _flags(d, f"{run}_one", *extra))
        out = proc.communicate(timeout=TIMEOUT)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out[-4000:]
    want = {"data": 1, "model": 2} if extra else {"data": 2, "model": 1}
    assert f"mesh: {want} over 2 processes, backend gloo" in out
    with open(history) as f:
        assert hist == json.load(f)
    assert len(hist["loss"]) == 2 == ts.step
    payload = CheckpointManager(f"{d}/{run}_launcher/model").load_payload(-1)
    assert payload["step"] == ts.step
    got = ts.model.state_dict()
    assert got.keys() == payload["model"].keys()
    for k, v in payload["model"].items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("how", ["18", "1"])
def test_the_command_exits_with_the_failing_ranks_code(shard_dir, tmp_path,
                                                       how):
    """`python -m ...train --device cpu,cpu` becomes the launcher: rank 1
    exiting 18 (or 1) at the first logging step is the command's exit
    code, and torchrun's report names rank 1."""
    (tmp_path / "sitecustomize.py").write_text(_SITE)
    env = _env(RANK_FAULT=how)
    env["PYTHONPATH"] = str(tmp_path) + os.pathsep + env["PYTHONPATH"]
    r = subprocess.run(
        [sys.executable, "-m", train_cli.MODULE, "--device", "cpu,cpu"]
        + _flags(shard_dir, f"fault{how}"), cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == int(how), r.stderr[-4000:]
    assert "rank      : 1 (local_rank: 1)" in r.stderr, r.stderr[-4000:]


class _Reached(Exception):
    pass


def _two_gpus(monkeypatch, visible=None):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)


def _no_torchrun(monkeypatch):
    for k in distributed.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)


def test_under_torchrun_nothing_is_launched_again(monkeypatch, tmp_path):
    """With torchrun's variables set (torchrun, the launcher, run.sh's
    train stage), --device cuda on a two-GPU host trains in this process:
    train.main goes on to join the group, and no launcher starts."""
    _two_gpus(monkeypatch)
    _no_torchrun(monkeypatch)
    assert launch.ranks_for("cuda") == launch.Ranks(
        2, "cuda", {"CUDA_VISIBLE_DEVICES": "0,1"})
    for k, v in dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0",
                     MASTER_ADDR="localhost", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    assert launch.ranks_for("cuda") is None
    assert launch.ranks_for("cuda", num_partitions=2) is None

    def refuse(*args, **kwargs):
        raise AssertionError("a second launch")

    def joined(*args, **kwargs):
        raise _Reached

    monkeypatch.setattr(launch, "exec_launcher", refuse)
    monkeypatch.setattr(launch, "run_launcher", refuse)
    monkeypatch.setattr(distributed, "maybe_initialize", joined)
    args = [a if a != "cpu" else "cuda" for a in cli_args(str(tmp_path))]
    with pytest.raises(_Reached):
        train_cli.main(args, exec_launcher=True)


def test_a_list_of_gpus_reaches_the_ranks_as_visible_devices(monkeypatch):
    """cuda:1,cuda:0 is two ranks seeing those GPUs in that order, mapped
    through the CUDA_VISIBLE_DEVICES this process has; one GPU, the CPU
    or a GPU named twice start nothing or raise."""
    _no_torchrun(monkeypatch)
    _two_gpus(monkeypatch, visible="5,3,7")
    assert launch.ranks_for("cuda:1,cuda:0") == launch.Ranks(
        2, "cuda", {"CUDA_VISIBLE_DEVICES": "3,5"})
    assert launch.ranks_for("cuda") == launch.Ranks(
        2, "cuda", {"CUDA_VISIBLE_DEVICES": "5,3"})
    assert launch.ranks_for("cuda:1") is None
    assert launch.ranks_for("cpu") is None
    assert launch.ranks_for("cpu,cpu,cpu") == launch.Ranks(3, "cpu", {})
    with pytest.raises(ValueError, match="names a GPU more than once"):
        launch.ranks_for("cuda:0,cuda:0")
    with pytest.raises(ValueError, match="mixes the CPU and GPUs"):
        launch.ranks_for("cpu,cuda:0")
    cmd = launch.launcher_command(launch.ranks_for("cuda"), train_cli.MODULE,
                                  ["--epoch", "1"])
    assert cmd[1:] == ["-m", launch.MODULE, "--nproc_per_node", "2", "-m",
                       train_cli.MODULE, "--device", "cuda", "--epoch", "1"]


def test_a_rank_is_pinned_to_its_local_gpu(monkeypatch):
    """Under the ranks' CUDA_VISIBLE_DEVICES, maybe_initialize pins
    cuda:LOCAL_RANK of the GPUs the rank sees and joins NCCL with it."""
    _two_gpus(monkeypatch, visible="3,5")
    for k, v in dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1",
                     MASTER_ADDR="localhost", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    pinned, joined = [], []
    monkeypatch.setattr(torch.cuda, "set_device", pinned.append)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: joined.append((backend, kw)))
    monkeypatch.setattr(distributed, "is_initialized", lambda: False)
    assert distributed.maybe_initialize("cuda") is True
    assert pinned == [1]
    backend, kw = joined[0]
    assert backend == "nccl" and kw["device_id"] == torch.device("cuda", 1)
    assert (kw["rank"], kw["world_size"]) == (1, 2)


@pytest.mark.parametrize("device,k", [("cpu,cpu", 3), ("cpu", 2),
                                      ("cpu,cpu,cpu", 2)])
def test_partitions_that_do_not_divide_the_devices_raise(tmp_path, device,
                                                         k, monkeypatch):
    """As JAX's make_mesh: the device count must divide by
    --num_partitions; nothing is launched."""
    _no_torchrun(monkeypatch)
    args = [a if a != "cpu" else device for a in cli_args(str(tmp_path))]
    with pytest.raises(ValueError, match=f"not divisible by "
                       f"--num_partitions {k}"):
        train_cli.main(args + ["--num_partitions", str(k)])
