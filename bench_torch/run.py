"""Run one cell of the port's benchmark once.

    python3 -m bench_torch.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--control 1] [--fault <name>]

From the root of a checkout.  The cell's entry in BENCHMARK.json names its
configuration (bench_torch/configs/<config>.json) and traffic mix
(bench_torch/traffic/<mix>.json); the mix names its driver
(bench_torch/drivers/<driver>.py), and each per-layer metric has a reader
(bench_torch/metrics/<metric>.py).  With --trace 0 the result line holds
the cell's end-to-end metrics, with --trace 1 its per-layer metrics.
--control 1 reads the control beside the program (the plain reference in
TF32 in the program's place) and judges `correct` by the control: it must
come out false.  --fault <name> plants one of the drivers' faults under
the timed path (alter_token, state_unchanged, half_batch), for the
readings a limit is set from.  The last line of standard output is the
result; the numbers compared, each beside its limit, are the last lines
of standard error and the last key of the result.  A run that has loaded
JAX, jaxlib, flax or the JAX package by then prints no result, names them
on standard error and exits with 3.
"""

from __future__ import annotations

import os
import time

T_START = time.perf_counter()
# load from one process with few threads: no OpenMP or BLAS pool competes
# with the host-bound loops for the cores
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):          # run as a file: python3 bench_torch/run.py
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_torch import harness, traffic  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", action="append", default=[],
                   help="plant a fault under the timed path (the readings "
                   "that set a limit's upper end; never in a check)")
    return p.parse_args(argv)


def make_run(args, bench: dict, t_start: float, faults=(), config=None,
             mix=None) -> harness.Run:
    cell = harness.find(bench, "workloads", args.workload)
    entry = harness.find(bench, "configs", cell["config"])
    return harness.Run(
        workload=args.workload, seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), control=bool(args.control), t_start=t_start,
        bench=bench, cell=cell,
        config=config or harness.load_json(harness.ROOT / entry["file"]),
        mix=mix or traffic.load(cell["traffic"]), faults=tuple(faults),
        chips=cell["chips"])


def reported(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries this cell reports in this kind of run."""
    if not trace:
        return [m for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])]
    return [m for m in bench["per_layer"] if cell in m.get("workloads", [cell])]


def execute(run: harness.Run, device) -> str:
    """Drive the cell and return the result line."""
    import torch
    run.device = device
    before = harness.host_probe()
    harness.driver(run.mix).run(run)
    run.note(f"host probe: {before:.4f} s before set-up, "
             f"{harness.host_probe():.4f} s after the check")
    metrics = {}
    for m in reported(run.bench, run.workload, run.trace):
        if not run.trace:
            value = run.setup_s if m["name"] == "setup_s" else run.e2e.get(
                m["name"])
        else:
            reader = harness.load_module(harness.HERE / "metrics"
                                         / f"{m['name']}.py")
            value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = (value, m["unit"])
    cuda = device.type == "cuda"
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": run.chips, "memory_peak_bytes": run.memory_peak_bytes}
    breakdown = None
    if run.trace and run.traced is not None:
        info["busy_s"] = run.traced["busy_s"]
        info["window_s"] = run.traced["window_s"]
        breakdown = {"device_ops": run.traced["device_ops"],
                     "idle_gaps": run.traced["idle_gaps"]}
    # once the window, the check and the readers are done: whatever the
    # port, a library it uses or a module named at run time loaded
    found = harness.foreign_modules()
    if found:
        raise harness.Refused("the run loaded " + ", ".join(found))
    return harness.result_line(run, metrics, info, breakdown)


def main(argv=None) -> int:
    args = parse(argv)
    bench = harness.load_benchmark()
    run = make_run(args, bench, T_START, faults=args.fault)
    harness.set_cache_dirs()
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < run.chips:
        print(f"the cell needs {run.chips} GPUs, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    try:
        line = execute(run, torch.device("cuda:0"))
    except harness.Refused as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    harness.print_checks(run)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
