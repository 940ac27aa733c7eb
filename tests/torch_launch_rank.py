"""A two-rank job for tests/test_torch_launch.py (not a test module).

    python -m automatic_speech_recognition_torch.parallel.launch \\
        --nproc_per_node 2 tests/torch_launch_rank.py <how> [<marker>]

Both ranks join a gloo group.  Rank 1 then ends as <how> says: an exit
code ('18', '17', '20', '1'), 'kill' (SIGKILL to itself) or 'ok' (it
finishes with rank 0).  While rank 1 fails, rank 0 sleeps outside any
collective, so only torchrun's termination ends it, after rank 1.  With
<marker>, the job fails only while the marker file does not exist, and
rank 1 creates it, so the next launch succeeds.  `end` is that ending,
which tests/test_torch_train_every_device.py injects into the port's
train on its ranks."""

import os
import signal
import sys
import time


def end(how: str, rank: int, marker: str = None) -> None:
    """Rank 1 ends as `how` says (creating `marker` first, if given);
    rank 0 sleeps outside any collective until torchrun ends it."""
    if rank == 1:
        if marker:
            open(marker, "w").close()
        if how == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        sys.exit(int(how))
    time.sleep(600)


if __name__ == "__main__":
    import torch.distributed as dist

    how = sys.argv[1]
    marker = sys.argv[2] if len(sys.argv) > 2 else None
    fail = how != "ok" and not (marker and os.path.exists(marker))
    dist.init_process_group("gloo")
    dist.barrier()             # both ranks have looked for the marker
    if fail:
        end(how, dist.get_rank(), marker)
    dist.barrier()
    dist.destroy_process_group()
