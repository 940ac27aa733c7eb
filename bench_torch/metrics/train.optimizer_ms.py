"""Mean wall ms a window step of the program's `train.optimizer` span:
the gradient norm, the clip, Adam and the BN statistics (host time;
utils/spans.py)."""

from bench_torch.program_spans import phase_ms


def read(run):
    return phase_ms(run, "train.optimizer")
