"""Mean wall ms a window step of the program's `train.featurize` span:
the waveform perturbations and the fused frontend's launches inside
trainer.train_step (host time; utils/spans.py)."""

from bench_torch.program_spans import phase_ms


def read(run):
    return phase_ms(run, "train.featurize")
