"""Mean wall ms a window step of the program's `las.listener` span: the
listener's forward (the tanh-RNN pyramid) in the train step (host time;
utils/spans.py)."""

from bench_torch.program_spans import phase_ms


def read(run):
    return phase_ms(run, "las.listener")
