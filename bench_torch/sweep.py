"""Sweep the offered rate of an open-loop serving cell, to find the knee:
the highest rate whose backlog does not grow over the window.

    python3 -m bench_torch.sweep --workload <cell> --seed <n> \
        --seconds <s> --rates 20,40,60

Each rate is one run of the cell's driver in this process with the mix's
rate replaced; it prints one JSON line per rate: the tail, the median,
the latency of the first and the last tenth of the requests (a growing
backlog shows as the last tenth waiting far longer), and the batcher's
occupancy.  The rate found is written into the mix file by hand."""

from __future__ import annotations

import argparse
import copy
import json
import time
from types import SimpleNamespace

import numpy as np
import torch

from bench_torch import harness, run as runner, traffic


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    bench = harness.load_benchmark()
    cell = harness.find(bench, "workloads", args.workload)
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        mix = copy.deepcopy(traffic.load(cell["traffic"]))
        mix["arrivals"]["rate_per_s"] = rate
        one = SimpleNamespace(workload=args.workload, seed=args.seed + i,
                              seconds=args.seconds, trace=0, control=0)
        run = runner.make_run(one, bench, time.perf_counter(), mix=mix)
        res = json.loads(runner.execute(run, torch.device("cuda:0")))
        c = run.counters
        lat = run.spans.get("latency", [])
        tenth = max(len(lat) // 10, 1)
        print(json.dumps({
            "rate_per_s": rate, "requests": run.attempted,
            "failed": run.failed,
            "p95_ms": res["metrics"]["serve_p95_ms"]["value"],
            "first_tenth_ms": 1e3 * float(np.mean([x[0] for x in lat[:tenth]])),
            "last_tenth_ms": 1e3 * float(np.mean([x[0] for x in lat[-tenth:]])),
            "occupancy": c["rows"] / max(c["batches"], 1) / c["max_batch"],
            "correct": res["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
