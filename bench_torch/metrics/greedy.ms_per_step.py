"""Wall ms of the harness's span around each dispatched greedy batch
(featurize, listen, decoder loop, tokens back) over the decoder steps
those batches ran."""

from bench_torch.readers import ms_per_step


def read(run):
    return ms_per_step(run, "greedy.batch")
