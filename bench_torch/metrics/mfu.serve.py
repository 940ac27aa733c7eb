"""Model FLOPs the completed inputs need, counted from shapes, over the
window's seconds x chips x the dense peak of the configured precision, %."""

from bench_torch.readers import mfu


def read(run):
    return mfu(run)
