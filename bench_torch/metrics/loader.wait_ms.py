"""Mean wall ms a training step waited in next() on the DevicePrefetcher
in the window."""

from bench_torch.readers import span_mean_ms


def read(run):
    return span_mean_ms(run, "loader.next")
