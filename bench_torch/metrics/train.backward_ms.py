"""Mean wall ms a window step of the program's `train.backward` span:
torch.autograd.grad over the step's loss (host time; utils/spans.py)."""

from bench_torch.program_spans import phase_ms


def read(run):
    return phase_ms(run, "train.backward")
