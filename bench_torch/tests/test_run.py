"""The harness end to end on the CPU at tiny sizes, with the look for a
chip skipped: a sound run is correct, and each fault the cell can have,
planted under the timed path, makes `correct` false.  Also: no chip, no
result; JAX or the JAX package loaded in the run, no result; a new cell of an existing driver added with data files alone;
and a new configuration, with a reference module of its own, added with
new files alone; a train mix's limits name the numbers its check
compares."""

import hashlib
import json
import math
import os
import shutil
import subprocess
import sys

import pytest

from bench_torch import harness
from bench_torch.harness import HERE, ROOT
from bench_torch.tests import tiny

SERVE = dict(seconds=3.0, arrivals={"kind": "poisson", "rate_per_s": 4.0},
             durations={"kind": "lognormal", "median_s": 1.8, "sigma": 0.3,
                        "min_s": 1.3, "max_s": 3.5},
             batcher={"max_batch": 4, "max_wait_ms": 20,
                      "bucket_seconds": [1, 2, 4]}, stretch_s=8)
TRAIN = dict(seconds=2.0, durations={"kind": "buckets", "per_bucket": 4,
                                     "min_s": 0.5}, tokens_per_s=[10, 12])


def train_run(workload="las_pblstm_chan2016.train", **kw):
    r = tiny.tiny(workload, **TRAIN, **kw)
    r.config["values"].update(bucket_boundaries_train=[100, 200, 300],
                              bucket_batch_sizes=[4, 4, 4],
                              max_tokenlen_train=40)
    return r


CASES = {
    "serve": lambda **kw: tiny.tiny("las_cnn_bpe5k.serve_greedy", **SERVE, **kw),
    "train": train_run,
}
FAULTS = [("serve", "alter_token"), ("train", "state_unchanged"),
          ("train", "half_batch")]


@pytest.mark.parametrize("case", sorted(CASES))
def test_sound_run_is_correct(case):
    res = tiny.execute(CASES[case]())
    assert res["correct"] is True, res
    assert list(res)[-1] == "checks" and res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert "setup_s" in res["metrics"] and len(res["metrics"]) == 2


@pytest.mark.parametrize("case,fault", FAULTS)
def test_fault_is_not_correct(case, fault):
    res = tiny.execute(CASES[case](faults=(fault,)))
    assert res["correct"] is False, res


@pytest.mark.parametrize("names", [("loss", "first_grad", "change"),
                                   ("first_loss", "first_grad", "change"),
                                   ("first_loss",)])
def test_the_mix_names_the_numbers_compared(names):
    """A train mix's limits name the numbers its check compares, and only
    those; `first_loss` is the first step's gap, never above `loss`."""
    run = train_run()
    run.mix["check"]["limits"] = {"unknown_rows": 0.0,
                                  **{n: 1.0 for n in names}}
    res = tiny.execute(run)
    assert set(res["checks"]) == {"unknown_rows", *names}, res["checks"]
    assert res["correct"] is True, res


def test_first_loss_is_the_first_steps_gap():
    from bench_torch.drivers import train_loader
    got = {"loss": [2.0, 4.0, 8.0], "first_grad": {"a": 1.0},
           "change": {"a": 1.0}, "raw_grad": {"a": 1.0}}
    gaps = train_loader.compare([2.002, 4.0, 8.8], {"a": 1.0}, {"a": 1.0},
                                got)
    assert math.isclose(gaps["first_loss"], 1e-3)
    assert math.isclose(gaps["loss"], 0.1)


def test_a_mix_naming_an_unknown_number_is_refused():
    run = train_run()
    run.mix["check"]["limits"] = {"unknown_rows": 0.0, "lossy": 1.0}
    with pytest.raises(ValueError, match="lossy"):
        tiny.execute(run)


def test_traced_run_reports_per_layer_metrics():
    run = CASES["serve"](trace=1)
    run.mix["trace_s"] = 0.5
    res = tiny.execute(run)
    assert {"batcher.queue_wait_ms", "batcher.occupancy",
            "greedy.ms_per_step", "mfu.serve"} <= set(res["metrics"])
    # the CPU has no device trace: the device metrics stay out
    assert "device.idle.serve" not in res["metrics"]


def test_no_chip_no_result(capsys):
    from bench_torch import run
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    rc = run.main(["--workload", "las_pblstm_chan2016.train", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


@pytest.mark.parametrize("name,found", [
    ("jax", ["jax"]), ("jaxlib.xla_client", ["jaxlib"]),
    ("flax.linen", ["flax"]),
    ("automatic_speech_recognition_tpu.models", [
        "automatic_speech_recognition_tpu"]),
    ("jaxtyping", []), ("automatic_speech_recognition_tpu_extra", [])])
def test_foreign_modules_by_whole_top_level_names(monkeypatch, name, found):
    import types
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.foreign_modules() == found


def test_jax_loaded_in_a_run_gives_no_result(monkeypatch, capsys):
    """A stand-in `jax` put into sys.modules inside a tiny train run, as
    a module named at run time would: the run prints no result, names it
    on standard error, and exits with another code than 0."""
    import types
    import torch
    from bench_torch import run as runner
    assert harness.foreign_modules() == []
    given, real_driver, real_execute = CASES["train"](), harness.driver, runner.execute

    def driver(mix):
        def run(r):
            real_driver(mix).run(r)
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return types.SimpleNamespace(run=run)

    monkeypatch.setattr(harness, "driver", driver)
    monkeypatch.setattr(harness, "set_cache_dirs", lambda: None)
    monkeypatch.setattr(runner, "make_run", lambda *a, **k: given)
    monkeypatch.setattr(runner, "execute", lambda r, d: real_execute(
        r, torch.device("cpu")))
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc = runner.main(["--workload", "las_pblstm_chan2016.train", "--seed",
                      "1", "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0, out
    assert not any(line.startswith("{") for line in out.splitlines()), out
    assert "the run loaded jax" in err.splitlines()[-1]


def test_new_cell_from_data_files_alone(tmp_path):
    """A copy of the benchmark with one more mix file and the serving
    cell's entries (the program imported from this checkout): the harness
    finds the new cell's parts by name, as a later PR that adds the cell
    with data alone would need."""
    shutil.copytree(HERE, tmp_path / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    bench = tiny.with_spare(json.loads((ROOT / "BENCHMARK.json").read_text()))
    mix = json.loads((HERE / "traffic" / "serve_greedy.json").read_text())
    mix["arrivals"]["rate_per_s"] = 1.0
    (tmp_path / "bench_torch" / "traffic" / "serve_greedy_slow.json"
     ).write_text(json.dumps(mix))
    serve = harness.find(bench, "workloads", tiny.SERVE)
    bench["workloads"].append(dict(serve,
                                   name="las_cnn_bpe5k.serve_greedy_slow",
                                   traffic="serve_greedy_slow"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if tiny.SERVE in m.get("workloads", []):
            m["workloads"].append("las_cnn_bpe5k.serve_greedy_slow")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import types, time; from bench_torch import run, harness; "
            "a = types.SimpleNamespace(workload='las_cnn_bpe5k.serve_greedy_slow',"
            " seed=1, seconds=10, trace=0, control=0); "
            "r = run.make_run(a, harness.load_benchmark(), time.perf_counter()); "
            "print(r.mix['arrivals']['rate_per_s'], r.config['name'], "
            "harness.driver(r.mix).__name__, "
            "[m['name'] for m in run.reported(r.bench, a.workload, True)])")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": os.pathsep.join(
                             [str(tmp_path), str(ROOT)])})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("1.0 las_cnn_bpe5k "
                                 "bench_torch.drivers.serve_open_loop")
    assert "greedy.ms_per_step" in out.stdout


PROBE = '''"""LAS's reference with the forward count scaled by FACTOR and
every call of the interface recorded."""
from bench_torch.reference import las
from bench_torch.reference.las import *  # noqa: F401,F403

FACTOR = 7
CALLS = []


def param_spec(values):
    CALLS.append(("param_spec",))
    return las.param_spec(values)


def model_flops(values, frames, steps):
    CALLS.append(("model_flops", frames, steps))
    return FACTOR * las.model_flops(values, frames, steps)


def train_steps(w, values, batches, tf32=False):
    CALLS.append(("train_steps", len(batches)))
    return las.train_steps(w, values, batches, tf32)


def forced_logits(w, values, audio, lens, tokens):
    CALLS.append(("forced_logits", len(lens)))
    return las.forced_logits(w, values, audio, lens, tokens)
'''

# runs in the copy: each probe cell tiny through its driver; what the
# probe recorded, the run's FLOPs and mfu, and what LAS's own count
# gives for the same utterances.  The train driver counts each batch of
# 4 rows as the prefetcher copies it, set-up's and those fetched past the
# window too: the window's are the `attempted` batches in a row among
# them whose count, the probe's, sums to the run's FLOPs.
PROBE_RUNS = """
import json
from bench_torch import harness, work
from bench_torch.reference import las, las_probe as probe
from bench_torch.tests import tiny
from bench_torch.tests.test_run import SERVE, train_run

out = {}
for case, passes, make in (
        ("train", 3, lambda: train_run("las_probe.train")),
        ("serve", 1, lambda: tiny.tiny("las_probe.serve_greedy", **SERVE))):
    probe.CALLS.clear()
    run = make()
    res = tiny.execute(run)
    counted = [c[1:] for c in probe.CALLS if c[0] == "model_flops"]
    fe = work.frontend_ops_per_frame(run.values)
    starts = [0]
    if case == "train":
        assert set(run.values["bucket_batch_sizes"]) == {4}
        assert len(counted) % 4 == 0
        fed = [counted[i:i + 4] for i in range(0, len(counted), 4)]
        n = res["attempted"]
        starts = [k for k in range(len(fed) - n + 1)
                  if sum(3 * sum(f * fe + probe.FACTOR
                                 * las.model_flops(run.values, f, s)
                                 for f, s in b)
                         for b in fed[k:k + n]) == run.work["flops"]]
        counted = [r for b in fed[starts[0]:starts[0] + n] for r in b]
    front = passes * sum(f * fe for f, _ in counted)
    model = passes * sum(las.model_flops(run.values, f, s)
                         for f, s in counted)
    mfu = harness.load_module(harness.HERE / "metrics" / f"mfu.{case}.py")
    out[case] = dict(
        correct=res["correct"], reference=run.config["reference"],
        windows=len(starts),
        calls=sorted({c[0] for c in probe.CALLS}), flops=run.work["flops"],
        front=front, model=model, mfu=mfu.read(run),
        per_flop=100.0 / (run.window_s * run.chips * run.work["peak"]))
print(json.dumps(out))
"""


def digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_configuration_from_files_alone(tmp_path):
    """A copy of the benchmark with a configuration of another kind added
    as new files alone: its file, naming the reference module `las_probe`
    (LAS's, the forward count scaled by a factor, its calls recorded),
    and the cells' entries.  Through both drivers the weights' spec, the
    FLOPs and the check come from the probe's module, mfu's model part
    scales by the factor, and no file of the copied harness changes."""
    bench_dir = tmp_path / "bench_torch"
    shutil.copytree(HERE, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    before = digests(bench_dir)
    config = json.loads((HERE / "configs" / "las_pblstm_chan2016.json")
                        .read_text())
    config.update(name="las_probe", reference="las_probe")
    (bench_dir / "configs" / "las_probe.json").write_text(json.dumps(config))
    (bench_dir / "reference" / "las_probe.py").write_text(PROBE)
    bench = tiny.with_spare(json.loads((ROOT / "BENCHMARK.json").read_text()))
    bench["configs"].append(dict(bench["configs"][0], name="las_probe",
                                 file="bench_torch/configs/las_probe.json"))
    cells = {"las_pblstm_chan2016.train": "las_probe.train",
             tiny.SERVE: "las_probe.serve_greedy"}
    for cell, new in cells.items():
        bench["workloads"].append(dict(harness.find(bench, "workloads", cell),
                                       name=new, config="las_probe"))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if cell in m.get("workloads", []):
                m["workloads"].append(new)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "probe_runs.py").write_text(PROBE_RUNS)
    out = subprocess.run([sys.executable, "probe_runs.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": os.pathsep.join(
                             [str(tmp_path), str(ROOT)])})
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    factor = 7
    for case, check in (("train", "train_steps"), ("serve", "forced_logits")):
        r = got[case]
        assert r["correct"] is True and r["reference"] == "las_probe", r
        assert r["windows"] >= 1, r
        assert {"param_spec", "model_flops", check} <= set(r["calls"]), r
        assert r["model"] > 0
        assert r["flops"] == r["front"] + factor * r["model"], r
        # mfu's model part is the factor times what LAS's count gives
        las_mfu = r["per_flop"] * (r["front"] + r["model"])
        front_mfu = r["per_flop"] * r["front"]
        assert math.isclose(r["mfu"] - front_mfu,
                            factor * (las_mfu - front_mfu), rel_tol=1e-9), r
    after = digests(bench_dir)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {"configs/las_probe.json",
                                        "reference/las_probe.py"}
