"""The harness end to end on the CPU at tiny sizes, with the look for a
chip skipped: a sound run is correct, and each fault the cell can have,
planted under the timed path, makes `correct` false.  Also: no chip, no
result; and a new cell of an existing driver added with data files
alone."""

import json
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


def train_run(**kw):
    r = tiny.tiny("las_pblstm_chan2016.train", **TRAIN, **kw)
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
