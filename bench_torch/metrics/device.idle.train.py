"""Share of the traced stretch with no kernel or copy on the device."""

from bench_torch.readers import idle_share


def read(run):
    return idle_share(run)
