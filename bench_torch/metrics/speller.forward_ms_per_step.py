"""Wall ms of the program's `las.speller` spans (the teacher-forced
decoder loop) over the decoder steps they ran (its `las.speller.steps`
counter), in the window (host time; utils/spans.py)."""

from bench_torch.program_spans import window


def read(run):
    w = window(run)
    if w is None or not w["counts"]["las.speller.steps"]:
        return None
    return w["ns"]["las.speller"] / w["counts"]["las.speller.steps"] / 1e6
