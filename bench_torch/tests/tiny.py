"""Tiny versions of the cells for CPU tests: the cell's own configuration
and mix with every width and count shrunk, run through the same drivers
with the look for a chip skipped."""

from __future__ import annotations

import copy
import time
from types import SimpleNamespace

import torch

from bench_torch import harness, run as runner, traffic

TINY_VALUES = dict(vocab_size=40, feat_dim=8, num_mel_filters=20,
                   num_enc_channels=4, enc_units=16, num_enc_layers=2,
                   attention_size=8, loc_kernel_size=5, loc_num_channels=2,
                   dec_units=16, embedding_size=8)

# the serving cell, kept out of BENCHMARK.json while the host's speed
# spreads its tail past the bound (PERF.md, open questions): the entries
# that put it back, which the CPU tests add to their copy
SERVE = "las_cnn_bpe5k.serve_greedy"
SPARE = {
    "configs": [{"name": "las_cnn_bpe5k", "reduced": [],
                 "source": "https://github.com/30stomercury/Automatic-Speech-"
                           "Recognition/blob/master/run.sh",
                 "file": "bench_torch/configs/las_cnn_bpe5k.json",
                 "why": "the recipe at its published widths, joint CTC: cnn "
                        "listener, location-aware attention, bpe-5k output"}],
    "workloads": [{"name": SERVE, "config": "las_cnn_bpe5k",
                   "traffic": "serve_greedy", "chips": 1,
                   "why": "callers of serve/Recognizer: Poisson 1.3-35 s "
                          "requests at 24 req/s, about half the knee; loads "
                          "the batcher and the greedy loop, bypasses beam "
                          "search"}],
    "end_to_end": [{"name": "serve_p95_ms", "unit": "ms", "better": "lower",
                    "bound": 0.25, "source": "host_clock",
                    "workloads": [SERVE]}],
    "per_layer": [
        {"name": name, "unit": unit, "better": better, "source": source,
         "layer": layer, "moves": "serve_p95_ms", "workloads": [SERVE]}
        for name, unit, better, source, layer in (
            ("batcher.queue_wait_ms", "ms", "lower", "program_counter",
             "batcher"),
            ("batcher.occupancy", "%", "higher", "program_counter", "batcher"),
            ("greedy.ms_per_step", "ms", "lower", "program_span",
             "recognizer / greedy loop"),
            ("device.idle.serve", "%", "lower", "device_trace", "device"),
            ("mfu.serve", "%", "higher", "host_clock", "whole step"))]}


def with_spare(bench: dict) -> dict:
    """A copy of BENCHMARK.json with the serving cell's entries added."""
    bench = copy.deepcopy(bench)
    for key, entries in SPARE.items():
        bench[key].extend(copy.deepcopy(entries))
    return bench



def tiny(workload: str, seed: int = 7, seconds: float = 2.0, trace: int = 0,
         control: int = 0, faults=(), **mix_changes) -> harness.Run:
    bench = with_spare(harness.load_benchmark())
    cell = harness.find(bench, "workloads", workload)
    entry = harness.find(bench, "configs", cell["config"])
    config = copy.deepcopy(harness.load_json(harness.ROOT / entry["file"]))
    config["values"].update(TINY_VALUES)
    if config["values"]["enc_type"] == "pblstm":
        config["values"]["feat_dim"] = 8
    mix = copy.deepcopy(traffic.load(cell["traffic"]))
    for key, value in mix_changes.items():
        target = mix
        *path, last = key.split("__")
        for p in path:
            target = target[p]
        target[last] = value
    args = SimpleNamespace(workload=workload, seed=seed, seconds=seconds,
                           trace=trace, control=control)
    return runner.make_run(args, bench, time.perf_counter(), faults, config,
                           mix)


def execute(run: harness.Run) -> dict:
    import json
    torch.manual_seed(0)
    return json.loads(runner.execute(run, torch.device("cpu")))
