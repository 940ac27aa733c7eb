"""Share of the window's `train.step` time that none of its five phases
(train.featurize, las.listener, las.speller, train.backward,
train.optimizer) covers, %: the loss, the step's metrics and casts.  A
large share says the spans miss where the time goes."""

from bench_torch.program_spans import window


def read(run):
    w = window(run)
    if w is None or not w["step_ns"]:
        return None
    return 100.0 * (1.0 - w["covered_ns"] / w["step_ns"])
