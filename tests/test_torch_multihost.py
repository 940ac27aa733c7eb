"""Training across hosts, one command a host (automatic_speech_recognition_
torch/train.py with parallel/launch.py's static rendezvous), as the JAX
package's multi-process path runs (README "Multi-host TPU pods",
tests/test_distributed.py), and the exit rule of a rank that fails
(parallel/distributed.run_main).

Two `python -m ...train --device cpu,cpu --num_partitions 2` commands run
side by side as hosts 0 and 1 of a job, each given the JAX package's
multi-host environment (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES,
JAX_PROCESS_ID): four gloo ranks at dp 2 x tp 2.  A sitecustomize
(_SITE) records, on every rank, torchrun's numbering, the ranks of its
model group, what a checkpoint restore gave it and the checkpoint files
it wrote, and injects a transient error on one rank where asked.  Held:

- the layout: host h runs global ranks 2h and 2h + 1, and each model
  group is one host's ranks;
- two steps, then two more resumed from the epoch-1 checkpoint, give the
  losses of one process on the same global batches within rtol 1e-4 /
  atol 1e-5 (tests/test_torch_distributed.py's two-rank tolerance), on
  both hosts alike; the checkpoint is written once, by the primary, and
  restored at step 2 by all four ranks;
- rank 3 raising an error with a transient marker at its first flag
  exchange: host 1's command exits 18, host 0's 17 or 18, each within
  FAULT_S seconds of the fault (gloo reports the dead peer as
  "Connection closed by peer", a transient marker);
- the refusals: hosts of unequal device counts (in the ranks, before the
  group), a --num_partitions that does not divide one host's devices,
  global batches that do not divide by the data axis, and a malformed
  environment (in the command, before any rank starts).

The exit rule itself, with torch.distributed monkeypatched: a failing
exit with a group up aborts the group and exits at once; a clean exit
destroys it."""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch.distributed as dist
from torch.distributed import distributed_c10d

from automatic_speech_recognition_torch import train as train_cli
from automatic_speech_recognition_torch.parallel import distributed, launch
from automatic_speech_recognition_torch.training.checkpoint import (
    CheckpointManager)

from test_torch_distributed import _free_port, _retrying
from test_torch_train_cli import _args as cli_args
from test_torch_train_cli import _shards as cli_shards

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
TIMEOUT = 240
# a host's command must end this soon after the injected fault
FAULT_S = 60
TP2 = ["--num_partitions", "2"]

# every rank (RANK set by torchrun) appends its records to
# $MULTIHOST_RECORD/rank<RANK>.jsonl; with MULTIHOST_FAULT=<rank>, that
# rank raises a transient error at its first flag exchange (writing the
# time to fault.json first) and the others go into the collective
_SITE = r"""
import json, os, time
if "RANK" in os.environ and os.environ.get("MULTIHOST_RECORD"):
    import torch
    import torch.distributed as dist
    from automatic_speech_recognition_torch.parallel import distributed
    from automatic_speech_recognition_torch.training import checkpoint

    out = os.environ["MULTIHOST_RECORD"]
    rank = int(os.environ["RANK"])

    def record(**kv):
        with open(os.path.join(out, f"rank{rank}.jsonl"), "a") as f:
            f.write(json.dumps(kv) + "\n")

    model_grid = distributed.model_grid

    def grid(k):
        g = model_grid(k)
        record(kind="grid", rank=rank, world=int(os.environ["WORLD_SIZE"]),
               host=int(os.environ["GROUP_RANK"]),
               local=int(os.environ["LOCAL_RANK"]),
               model_group=dist.get_process_group_ranks(g.model_group))
        return g

    distributed.model_grid = grid
    restore = checkpoint.CheckpointManager.restore

    def restored(self, ts, *args, **kwargs):
        got = restore(self, ts, *args, **kwargs)
        record(kind="restore", found=got is not None, step=ts.step)
        return got

    checkpoint.CheckpointManager.restore = restored
    save = torch.save

    def saved(obj, f, *args, **kwargs):
        record(kind="save", name=os.path.basename(getattr(f, "name", str(f))))
        return save(obj, f, *args, **kwargs)

    torch.save = saved
    any_flag = distributed.any_flag
    fault = os.environ.get("MULTIHOST_FAULT")

    def flags(*args, **kwargs):
        if fault is not None and rank == int(fault):
            with open(os.path.join(out, "fault.json"), "w") as f:
                json.dump({"at": time.time()}, f)
            raise RuntimeError(f"rank {rank}: injected transport failure: "
                               "Connection reset by peer")
        return any_flag(*args, **kwargs)

    distributed.any_flag = flags
"""


@pytest.fixture(scope="module")
def site(tmp_path_factory):
    d = tmp_path_factory.mktemp("multihost_site")
    (d / "sitecustomize.py").write_text(_SITE)
    return str(d)


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("multihost"))
    cli_shards(d, np.random.default_rng(0))
    return d


def _flags(d, run, *extra):
    """The train CLI test's flags without --device, into run's own
    directories."""
    args = cli_args(d)[2:]
    args[args.index("--save_dir") + 1] = f"{d}/{run}/model"
    args[args.index("--summary_dir") + 1] = f"{d}/{run}/summary"
    return args + list(extra)


def _steps(epochs):
    return ["--epoch", str(epochs), "--steps_per_epoch", "2"]


def _env(site, **extra):
    path = os.environ.get("PYTHONPATH")
    env = {k: v for k, v in os.environ.items()
           if k not in distributed.TORCHRUN_ENV + launch.HOSTS_ENV}
    return {**env,
            "PYTHONPATH": os.pathsep.join(
                [site, REPO] + ([path] if path else [])), **extra}


def _two_hosts(site, record, flags, devices=("cpu,cpu", "cpu,cpu"),
               **extra):
    """Host i runs `python -m ...train --device devices[i] flags` with the
    multi-host environment; returns each command's (exit code, output,
    time.time() at its exit).  Both are waited for or killed."""
    os.makedirs(record, exist_ok=True)
    port = str(_free_port())
    procs, logs = [], [f"{record}/host{i}.log" for i in range(2)]
    for i, device in enumerate(devices):
        env = _env(site, JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(i),
                   MULTIHOST_RECORD=record,
                   **{train_cli.HISTORY_ENV: f"{record}/history{i}.json"},
                   **extra)
        with open(logs[i], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", train_cli.MODULE, "--device", device]
                + flags, env=env, cwd=site, stdout=log,
                stderr=subprocess.STDOUT))
    ended = [None, None]
    t0 = time.time()
    try:
        while None in ended and time.time() - t0 < TIMEOUT:
            for i, p in enumerate(procs):
                if ended[i] is None and p.poll() is not None:
                    ended[i] = time.time()
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return [(p.returncode, open(log).read(), end)
            for p, log, end in zip(procs, logs, ended)]


def _records(record):
    out = {}
    for r in range(4):
        path = f"{record}/rank{r}.jsonl"
        out[r] = ([json.loads(l) for l in open(path)]
                  if os.path.exists(path) else [])
    return out


def _kind(recs, kind):
    return [x for x in recs if x["kind"] == kind]


def _history(record, i):
    with open(f"{record}/history{i}.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def job(site, shard_dir):
    """Two hosts x two ranks at tp 2: two steps (epoch 1, a checkpoint),
    then two more resumed from it; and the same two runs in one process.
    Returns (each run's host results, records, histories; one process's
    histories)."""
    d = shard_dir

    def run(attempt):
        runs = {}
        for name, epochs in (("first", 1), ("resumed", 2)):
            record = f"{d}/job{attempt}/{name}"
            res = _two_hosts(site, record, _flags(
                d, f"job{attempt}", *TP2, *_steps(epochs)))
            for code, out, _ in res:
                assert code == 0, out[-4000:]
            runs[name] = (res, _records(record),
                          [_history(record, i) for i in range(2)])
        return runs

    runs = _retrying(run)
    one = []
    for epochs in (1, 2):
        _, hist = train_cli.main(["--device", "cpu"] + _flags(
            d, "one", *_steps(epochs)))
        one.append(hist)
    return runs, one


def test_the_ranks_of_a_host_are_consecutive_and_hold_its_model_group(job):
    runs, _ = job
    res, recs, _ = runs["first"]
    grids = {r: _kind(recs[r], "grid")[0] for r in range(4)}
    for r, g in grids.items():
        assert g["world"] == 4 and g["host"] == r // 2
        assert g["local"] == r % 2
        assert g["model_group"] == [2 * (r // 2), 2 * (r // 2) + 1]
    assert "mesh: {'data': 2, 'model': 2} over 4 processes, backend gloo" \
        in res[0][1]
    assert "as host 1 of 2 (ranks 2-3 of 4)" in res[1][1]


def test_two_hosts_train_as_one_process(job):
    """Both hosts report the same history, equal to one process's on the
    same global batches, before and after the resume."""
    runs, one = job
    for name, want in zip(("first", "resumed"), one):
        _, _, hists = runs[name]
        assert hists[0] == hists[1]
        assert len(hists[0]["loss"]) == 2
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(hists[0][k], want[k], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{name} {k}")


def test_one_checkpoint_written_by_the_primary_resumed_by_every_rank(job):
    runs, _ = job
    _, first, _ = runs["first"]
    assert [x["name"] for x in _kind(first[0], "save")] == ["1.pt.tmp"]
    for r in (1, 2, 3):
        assert _kind(first[r], "save") == []
    _, resumed, _ = runs["resumed"]
    for r in range(4):
        assert _kind(resumed[r], "restore") == [
            {"kind": "restore", "found": True, "step": 2}]
    assert [x["name"] for x in _kind(resumed[0], "save")] == ["2.pt.tmp"]


def test_a_transient_failure_on_one_host_is_retried_on_both(site,
                                                            shard_dir,
                                                            tmp_path):
    """Rank 3 (host 1) raises an error carrying "Connection reset by
    peer" at its first flag exchange, while the others wait in theirs:
    host 1's command exits 18 (the rank aborts its group and leaves at
    once), host 0's 17 or 18 (its ranks' collective fails on the dead
    peer, or the stall watchdog ends it), each within FAULT_S seconds of
    the fault."""
    record = str(tmp_path / "fault")
    res = _two_hosts(site, record, _flags(
        shard_dir, "fault", *TP2, *_steps(1), "--stall_timeout_s", "45"),
        MULTIHOST_FAULT="3")
    (c0, out0, end0), (c1, out1, end1) = res
    assert c1 == 18, out1[-4000:]
    assert c0 in (17, 18), out0[-4000:]
    assert "transient platform failure" in out1
    assert "leaving with exit code 18" in out1
    with open(f"{record}/fault.json") as f:
        at = json.load(f)["at"]
    assert end1 - at < FAULT_S and end0 - at < FAULT_S, (end0 - at,
                                                          end1 - at)


def test_hosts_of_unequal_device_counts_are_refused(site, shard_dir,
                                                    tmp_path):
    """Host 0 with two devices, host 1 with one: every rank refuses before
    it joins a group, so both commands exit 1."""
    res = _two_hosts(site, str(tmp_path / "unequal"),
                     _flags(shard_dir, "unequal", *_steps(1)),
                     devices=("cpu,cpu", "cpu"))
    for code, out, _ in res:
        assert code == 1, out[-4000:]
        assert "ValueError: the hosts' device counts differ" in out


def _hosts_env(monkeypatch, count="2", index="0",
               coord="localhost:29999"):
    for k in distributed.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in zip(launch.HOSTS_ENV, (coord, count, index)):
        monkeypatch.setenv(k, v)


def _no_launch(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("launched")
    monkeypatch.setattr(launch, "exec_launcher", refuse)
    monkeypatch.setattr(launch, "run_launcher", refuse)


@pytest.mark.parametrize("device,extra,match", [
    ("cpu,cpu", ["--num_partitions", "3"], "not divisible by "
     "--num_partitions 3"),
    # 2 hosts x 2 ranks: a data axis of 4; a global batch of 6 rows
    ("cpu,cpu", ["--bucket_batch_sizes", "6,4"], r"\[6\] not divisible"),
    # 2 hosts x 2 ranks at tp 2: a data axis of 2; 3 rows
    ("cpu,cpu", [*TP2, "--bucket_batch_sizes", "4,3"],
     r"\[3\] not divisible"),
], ids=["partitions", "batch", "batch_tp2"])
def test_refusals_before_any_rank_starts(monkeypatch, tmp_path, device,
                                         extra, match):
    _hosts_env(monkeypatch)
    _no_launch(monkeypatch)
    with pytest.raises(ValueError, match=match):
        train_cli.main(["--device", device] + _flags(str(tmp_path), "r")
                       + list(extra))
    assert not distributed.is_initialized()


@pytest.mark.parametrize("coord,count,index,match", [
    ("localhost", "2", "0", "want host:port"),
    ("localhost:1234", "2", "2", "is not a host of"),
    ("localhost:1234", "two", "0", "want host:port"),
])
def test_a_malformed_multi_host_environment_is_refused(monkeypatch, coord,
                                                       count, index, match):
    _hosts_env(monkeypatch, count, index, coord)
    with pytest.raises(ValueError, match=match):
        launch.ranks_for("cpu")


def test_one_device_a_host_is_a_one_rank_node(monkeypatch):
    """Under the multi-host environment one device still starts a rank
    (host 1 of 3 here), through a static rendezvous at host 0's address;
    without it, one device trains alone."""
    _hosts_env(monkeypatch, "3", "1", "10.0.0.5:4242")
    ranks = launch.ranks_for("cpu")
    assert ranks == launch.Ranks(1, "cpu", {}, launch.Hosts(3, 1, "10.0.0.5",
                                                            4242))
    assert ranks.world == 3
    cmd = launch.launcher_command(ranks, train_cli.MODULE, ["--epoch", "1"])
    assert cmd[1:] == ["-m", launch.MODULE, "--nnodes", "3", "--node_rank",
                       "1", "--master_addr", "10.0.0.5", "--master_port",
                       "4242", "--nproc_per_node", "1", "-m",
                       train_cli.MODULE, "--device", "cpu", "--epoch", "1"]
    assert launch._standalone(cmd[3:]) == cmd[3:]
    assert launch._standalone(["--nproc_per_node", "2", "x.py"])[0] == \
        "--standalone"
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    assert launch.ranks_for("cpu") is None
    assert launch.ranks_for("cpu,cpu") == launch.Ranks(2, "cpu", {})


class _Exited(Exception):
    pass


@pytest.fixture
def group_up(monkeypatch):
    """A process group that looks up; the calls that leave it recorded."""
    calls = []
    monkeypatch.setattr(distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda *a: calls.append("destroy"))
    monkeypatch.setattr(distributed_c10d, "_abort_process_group",
                        lambda *a: calls.append("abort"))

    def exit_now(code):
        calls.append(("os._exit", code))
        raise _Exited

    monkeypatch.setattr(os, "_exit", exit_now)
    return calls


def test_a_clean_exit_destroys_the_group(group_up):
    distributed.run_main(lambda: None)
    assert group_up == ["destroy"]
    with pytest.raises(SystemExit):
        distributed.run_main(lambda: sys.exit(0))
    assert group_up == ["destroy", "destroy"]


@pytest.mark.parametrize("end,code", [
    (lambda: sys.exit(18), 18), (lambda: sys.exit(17), 17),
    (lambda: sys.exit("bad"), 1), (lambda: 1 / 0, 1)],
    ids=["18", "17", "message", "exception"])
def test_a_failing_exit_aborts_the_group_and_leaves_at_once(group_up,
                                                            capsys, end,
                                                            code):
    with pytest.raises(_Exited):
        distributed.run_main(end)
    assert group_up == ["abort", ("os._exit", code)]
    if code == 1:
        err = capsys.readouterr().err
        assert "ZeroDivisionError" in err or "bad" in err


def test_without_a_group_exits_pass_as_they_are(monkeypatch):
    monkeypatch.setattr(distributed, "is_initialized", lambda: False)
    with pytest.raises(SystemExit) as e:
        distributed.run_main(lambda: sys.exit(18))
    assert e.value.code == 18
    with pytest.raises(ZeroDivisionError):
        distributed.run_main(lambda: 1 / 0)


def test_nccl_errors_are_left_to_an_armed_stall_watchdog(monkeypatch):
    """NCCL's default error handling aborts a rank whose peer died (134);
    under a stall watchdog it is turned off, unless the environment names
    a mode; without a watchdog it stays."""
    key = "TORCH_NCCL_ASYNC_ERROR_HANDLING"
    monkeypatch.delenv(key, raising=False)
    distributed.leave_nccl_errors_to_the_watchdog(0)
    assert key not in os.environ
    distributed.leave_nccl_errors_to_the_watchdog(900)
    assert os.environ[key] == "0"
    monkeypatch.setenv(key, "3")
    distributed.leave_nccl_errors_to_the_watchdog(900)
    assert os.environ[key] == "3"


def test_the_collective_timeout_outlasts_the_stall_watchdog():
    """NCCL's own timeout (10 minutes) would abort a blocked rank (exit
    134) before run.sh's 900 s watchdog (17): the group's timeout is
    raised past it; the defaults stand otherwise."""
    assert distributed.collective_timeout("nccl", 0) is None
    t = distributed.collective_timeout("nccl", 900)
    assert t.total_seconds() == 1800
    assert distributed.collective_timeout("gloo", 30).total_seconds() == \
        30 * 60
