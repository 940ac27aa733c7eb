"""The frontend kernels' share of their roofline in training steps, %:
least time (audio read once, features written once; the function's
operations at the TF32 peak) over their traced device time."""

from bench_torch.readers import frontend_roofline


def read(run):
    return frontend_roofline(run)
