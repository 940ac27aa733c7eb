"""Start the ranks of a one-host job as torchrun does, and exit with the
code of the rank that failed first.

    python3 -m automatic_speech_recognition_torch.parallel.launch \\
        --nproc_per_node N -m automatic_speech_recognition_torch.train <flags>

It takes torch.distributed.run's arguments and, unless a rendezvous
endpoint is given, runs --standalone (a rendezvous on localhost at a free
port).  torchrun itself exits 1 whenever a rank fails (ChildFailedError),
so a supervisor around it (tools/train_supervised.sh) cannot tell a
transient failure from a bug.  Here the exit code is the failing rank's:

- the rank that failed first (ChildFailedError.get_first_failure, by
  timestamp; the ranks torchrun terminated after it are ignored) gives
  its exit code as it is: 17 (stall watchdog), 18 (transient platform
  failure, utils/platform.py), 20 (diverged, never retried), 1 (a bug) or
  any other;
- a rank killed by a signal gives 128 + the signal's number, as a shell
  reports it: SIGKILL (in practice the OOM killer) is 137, which the
  supervisor retries.

So a multi-GPU train stage keeps the exit-code contract that one JAX
process per host keeps.  torchrun's report of every failed rank goes to
stderr first.

`train` starts its ranks through this launcher itself when --device names
several devices and no torchrun environment is set (`ranks_for`), as the
JAX package's train.py builds its mesh over every local device: the CLI
replaces its process with the launcher (`exec_launcher`), a caller of
train.main runs it as a child (`run_launcher`).
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence

from ..utils.device import cuda_visible
from . import distributed
from .mesh import devices_for

MODULE = "automatic_speech_recognition_torch.parallel.launch"
# the directory that holds the package: on the ranks' PYTHONPATH, so they
# import the port from any working directory
_ROOT = str(Path(__file__).resolve().parents[2])


def exit_code(exc) -> int:
    """The launcher's exit code for a ChildFailedError: the first
    failure's code, or 128 + N for a death by signal N."""
    _, failure = exc.get_first_failure()
    code = failure.exitcode
    return 128 - code if code < 0 else code


def _standalone(argv: List[str]) -> List[str]:
    flags = {a.split("=")[0] for a in argv}
    if flags & {"--standalone", "--rdzv_endpoint", "--rdzv-endpoint"}:
        return argv
    return ["--standalone"] + argv


class Ranks(NamedTuple):
    """The processes a command starts for a --device list: `nproc` ranks,
    each given --device `device` (torchrun pins cuda:LOCAL_RANK) and the
    environment `env` (the GPUs they see)."""
    nproc: int
    device: str
    env: Dict[str, str]


def ranks_for(name: str, num_partitions: int = 1) -> Optional[Ranks]:
    """The ranks `train --device name` starts, one a device, or None where
    this process trains alone: under torchrun's environment (torchrun or
    this launcher started it) and for a single device ('cuda:N', 'cpu',
    plain 'cuda' on a one-GPU host).  A list of GPUs reaches the ranks as
    CUDA_VISIBLE_DEVICES (utils/device.cuda_visible), so rank r drives the
    r-th of them.  Raises ValueError where num_partitions does not divide
    the devices (JAX's make_mesh), for a GPU named twice (one NCCL rank a
    GPU) and for the CPU and GPUs mixed.  Creates no CUDA context."""
    if all(k in os.environ for k in distributed.TORCHRUN_ENV):
        return None
    devices = devices_for(name)
    if len(devices) % num_partitions:
        raise ValueError(
            f"--device {name!r} gives {len(devices)} device(s), not "
            f"divisible by --num_partitions {num_partitions} (one process "
            f"a partition): name a multiple of {num_partitions} devices, or "
            f"run torchrun --nproc_per_node {num_partitions} -m "
            "automatic_speech_recognition_torch.train")
    if len(devices) == 1:
        return None
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return Ranks(len(devices), "cpu", {})
    if kinds != {"cuda"}:
        raise ValueError(f"--device {name!r} mixes the CPU and GPUs: the "
                         "ranks of one job run on one kind of device")
    index = [d.index for d in devices]
    if len(set(index)) < len(index):
        raise ValueError(f"--device {name!r} names a GPU more than once: "
                         "each rank needs a GPU of its own")
    return Ranks(len(devices), "cuda",
                 {"CUDA_VISIBLE_DEVICES": cuda_visible(index)})


def launcher_command(ranks: Ranks, module: str,
                     argv: Sequence[str]) -> List[str]:
    """This launcher running `python -m module --device <rank device>
    argv` on each rank."""
    return [sys.executable, "-m", MODULE, "--nproc_per_node",
            str(ranks.nproc), "-m", module, "--device", ranks.device,
            *argv]


def launcher_env(ranks: Ranks, extra: Optional[Dict[str, str]] = None
                 ) -> Dict[str, str]:
    path = os.environ.get("PYTHONPATH")
    return {**os.environ, **ranks.env, **(extra or {}),
            "PYTHONPATH": _ROOT + (os.pathsep + path if path else "")}


def exec_launcher(ranks: Ranks, module: str, argv: Sequence[str]) -> None:
    """Replace this process with the launcher: a supervisor's signals and
    the exit code are the launcher's from here on.  Does not return."""
    cmd = launcher_command(ranks, module, argv)
    sys.stdout.flush()
    sys.stderr.flush()
    os.execve(cmd[0], cmd, launcher_env(ranks))


def run_launcher(ranks: Ranks, module: str, argv: Sequence[str],
                 extra_env: Optional[Dict[str, str]] = None) -> int:
    """The launcher as a child process: its exit code.  If this process is
    interrupted meanwhile, the launcher is sent SIGTERM (which torchrun
    passes on to the ranks) and waited for, then killed."""
    proc = subprocess.Popen(launcher_command(ranks, module, argv),
                            env=launcher_env(ranks, extra_env))
    try:
        return proc.wait()
    except BaseException:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        raise


def main(argv: Optional[Sequence[str]] = None) -> int:
    from torch.distributed.elastic.multiprocessing.errors import \
        ChildFailedError
    from torch.distributed import run
    args = run.parse_args(_standalone(list(sys.argv[1:] if argv is None
                                            else argv)))
    try:
        run.run(args)
    except ChildFailedError as e:
        print(e, file=sys.stderr, flush=True)
        return exit_code(e)
    return 0


if __name__ == "__main__":
    sys.exit(main())
