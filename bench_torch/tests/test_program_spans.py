"""The six readers of the program's own spans (program_spans.py) on the
tiny training cell on the CPU, and their refusals: a ring that dropped
records, or fewer train.step records than the window's steps."""

import time
from types import SimpleNamespace

import pytest

from bench_torch import harness, program_spans
from bench_torch.tests import tiny
from bench_torch.tests.test_run import train_run

spans = pytest.importorskip("automatic_speech_recognition_torch.utils.spans")

READERS = ("frontend.featurize_ms", "listener.forward_ms",
           "speller.forward_ms_per_step", "train.backward_ms",
           "train.optimizer_ms", "train.unspanned_pct")


def read(name, run):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py"
                               ).read(run)


def test_traced_train_run_reads_every_phase():
    run = train_run(trace=1)
    res = tiny.execute(run)
    assert res["correct"] is True, res
    assert set(READERS) <= set(res["metrics"]), sorted(res["metrics"])
    w = program_spans.window(run)
    assert w["steps"] == len(run.spans["loader.next"])
    assert all(w["calls"][p] == w["steps"] for p in program_spans.PHASES)
    # the five phases and the unspanned share make up the steps
    share = res["metrics"]["train.unspanned_pct"]["value"] / 100
    phases = sum(w["ns"].values()) / w["step_ns"]
    assert phases + share == pytest.approx(1.0, abs=1e-9)
    for name, phase in zip(READERS, program_spans.PHASES):
        if name != "speller.forward_ms_per_step":
            assert res["metrics"][name]["value"] == pytest.approx(
                w["ns"][phase] / w["steps"] / 1e6)
    per_step = res["metrics"]["speller.forward_ms_per_step"]["value"]
    assert per_step * w["counts"]["las.speller.steps"] == pytest.approx(
        w["ns"]["las.speller"] / 1e6)


def fake_run(steps):
    """A run whose set-up ended now and whose window held `steps` steps."""
    return SimpleNamespace(t_start=time.perf_counter(), setup_s=0.0,
                           spans={"loader.next": [(0.0,)] * steps})


def phase_step():
    with spans.span("train.step"):
        for name in program_spans.PHASES:
            with spans.span(name):
                pass
        spans.count("las.speller.steps", 4)


@pytest.fixture
def fresh_ring():
    spans.reset()
    yield
    spans.reset()


def test_window_reads_the_first_steps_after_set_up(fresh_ring):
    phase_step()                      # a set-up step: before the window
    run = fake_run(2)
    for _ in range(3):                # two window steps, one after it
        phase_step()
    w = program_spans.window(run)
    assert w["steps"] == 2 and w["counts"]["las.speller.steps"] == 8
    assert all(v is not None for v in (read(n, run) for n in READERS))


def test_a_missing_step_reads_none(fresh_ring):
    run = fake_run(3)
    phase_step()
    phase_step()
    assert program_spans.window(run) is None
    assert all(read(n, run) is None for n in READERS)


def test_an_overflowed_ring_reads_none(fresh_ring):
    run = fake_run(1)
    phase_step()
    for _ in range(spans.RING):
        spans.count("filler")
    assert program_spans.window(run) is None
    assert all(read(n, run) is None for n in READERS)
