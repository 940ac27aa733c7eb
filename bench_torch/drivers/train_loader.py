"""Training throughput: trainer.train_step fed by BucketedLoader and
DevicePrefetcher over raw-audio shards that set-up writes from the seed.

Set-up: every utterance cut from one synthetic stretch (the mix's
bucket sizes and token counts, the seed's slices and token ids), written as raw-audio
shards into the run's own temporary directory; the program's LAS with
the yardstick's weights, its optimizer and a TrainState; the loader and
the prefetcher as train.py wires them.  The state's first steps go
through the same call and feed as the window's: the first `check.steps`
are the ones the reference follows, and the steps go on until every
bucket's shape has run once.  Window: steps until the window's seconds
are up, then a synchronize; with --trace 1 a few more steps after it are
profiled.  After it: the program is freed and the plain reference
follows the first steps from the same weights on the same rows: the
loss of each, the first gradient per leaf as Adam holds it after one
step, and each leaf's change after the last; the mix's limits name the
numbers compared (compare)."""

from __future__ import annotations

import collections
import gc
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from bench_torch import harness, synth, traffic, weights, work
from bench_torch.drivers.serve_open_loop import setup_phases
from bench_torch.reference.las import frame_params, num_frames
from bench_torch.trace import Stretch

FRONTEND_KERNELS = ("features_kernel", "cmvn_stats_kernel",
                    "cmvn_deltas_kernel")


def write_shards(run: harness.Run, directory: str):
    """The cell's utterances as raw-audio shards; returns the record keys
    (length, first samples) a fed row must match."""
    from automatic_speech_recognition_torch.data import shards

    mix, values = run.mix, run.values
    lengths = traffic.sizes(mix, values)
    source = synth.stretch(run.seed, mix["stretch_s"], values["sample_rate"])
    offs = traffic.offsets(run.seed, lengths, len(source))
    labels = traffic.labels(run.seed, lengths, mix, values)
    audio = [source[o:o + n] for o, n in zip(offs, lengths)]
    k = mix["shards"]
    for j in range(k):
        shards.write_shard(os.path.join(directory, f"train-{j}.arsh"),
                           [a[:, None, None] for a in audio[j::k]],
                           labels[j::k])
    return {(len(a), a[:16].tobytes()) for a in audio}


def leaf_gap(prog: dict, refr: dict, raw: dict) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger; leaves whose reference gradient is under a
    thousandth of the median leaf's (moved by round-off alone) are left
    out."""
    med_raw = float(np.median(list(raw.values())))
    keep = [k for k in refr if raw[k] >= 1e-3 * med_raw]
    med = float(np.median([refr[k] for k in keep]))
    return max(abs(prog[k] - refr[k]) / max(refr[k], med) for k in keep)


def run(run: harness.Run) -> None:
    from automatic_speech_recognition_torch.data.pipeline import (
        BucketedLoader, DevicePrefetcher)
    from automatic_speech_recognition_torch.ops import cuda_frontend
    from automatic_speech_recognition_torch.training import trainer
    from automatic_speech_recognition_torch.utils.device import (
        disable_tf32, host_tensor)

    dev, mix, values = run.device, run.mix, run.values
    cuda = dev.type == "cuda"
    if cuda:
        disable_tf32()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sr = values["sample_rate"]
    phases = [("imports", time.perf_counter())]
    cfg = harness.program_config(values, seed=run.seed)
    plain = harness.reference(run.config)
    w = weights.make(plain.param_spec(values), run.seed, dev)
    tmp = tempfile.mkdtemp(prefix="bench_train_")
    try:
        keys = write_shards(run, tmp)
        phases.append(("weights, shards", time.perf_counter()))
        files = sorted(os.path.join(tmp, f) for f in os.listdir(tmp))
        model = harness.build_model(cfg, w, dev).train()
        ts = trainer.TrainState(model, trainer.make_optimizer(model, cfg), 0,
                                torch.Generator(device=dev).manual_seed(
                                    run.seed))
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        # the loader's order from the shape seed: every run feeds the
        # same sequence of batch shapes
        loader = BucketedLoader(files, cfg, is_training=True,
                                seed=mix["shape_seed"])
        fed = collections.deque()

        def put(batch):
            """The prefetcher's copy to the device (make_mesh_train_step's
            shard_batch); notes what the batch holds, in feed order."""
            lens, toks = batch[1], batch[3]
            frames = [num_frames(int(n), values) for n in lens]
            flops = 3 * sum(work.forward_flops(plain, values, f, int(t))
                            for f, t in zip(frames, toks))
            S = batch[0].shape[1]
            fed.append((float(lens.sum()) / sr, flops,
                        (len(lens), S, max(num_frames(S, values), 1))))
            return tuple(host_tensor(x).to(dev) for x in batch)

        feed = DevicePrefetcher(iter(loader), put, depth=cfg.prefetch_depth)
        if "state_unchanged" in run.faults:
            ts.optimizer.update = lambda grads, group=None: None

        def step():
            t = time.perf_counter()
            with torch.profiler.record_function("bench.loader_next"):
                batch = next(feed)
            wait = time.perf_counter() - t
            given = batch
            if "half_batch" in run.faults:
                given = tuple(x[:len(x) // 2] for x in batch)
            with torch.profiler.record_function("bench.train_step"):
                metrics = trainer.train_step(ts, given, cfg)
            return batch, metrics, wait, fed.popleft()

        flen, fstep = frame_params(values)
        widths = {b * fstep + flen for b in values["bucket_boundaries_train"]}
        n_ref = mix["check"]["steps"]
        first, losses, seen = [], [], set()
        first_grad = change = None
        phases.append(("model, optimizer, loader", time.perf_counter()))
        while len(first) < n_ref or not widths <= seen:
            batch, metrics, _, _ = step()
            seen.add(batch[0].shape[1])
            if len(first) < n_ref:
                first.append(tuple(x.clone() for x in batch))
                losses.append(float(metrics["loss"]))
            if ts.step == 1:
                state = ts.optimizer.adam.state
                first_grad = {
                    n: (float(state[p]["exp_avg"].norm()) / 0.1
                        if p in state else 0.0)
                    for n, p in zip(names, ts.optimizer.params)}
            if ts.step == n_ref:
                with torch.no_grad():
                    change = {n: float((p - w[n]).norm())
                              for n, p in zip(names, ts.optimizer.params)}
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        run.setup_s = time.perf_counter() - run.t_start
        phases.append((f"{ts.step} first steps", time.perf_counter()))
        run.note(setup_phases(run.t_start, phases))
        run.note(f"set-up ran {ts.step} steps over {len(seen)} bucket "
                 f"widths; first losses {losses}")
        launches = cuda_frontend.fused_frontend.launches

        audio_s, flops = 0.0, 0.0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < run.seconds:
            _, _, wait, info = step()
            run.span("loader.next", wait)
            audio_s, flops = audio_s + info[0], flops + info[1]
        sync()
        run.window_s = time.perf_counter() - t0
        steps = len(run.spans.get("loader.next", []))
        if run.trace:
            # a traced run profiles a few more steps after the window
            with Stretch(FRONTEND_KERNELS) as s:
                for _ in range(mix["trace_steps"]):
                    run.span("frontend.traced", *step()[3][2])
            run.traced = s.result
        feed.close()
        run.e2e["train_audio_s_per_s"] = audio_s / run.window_s
        run.work.update(flops=flops, peak=work.peak(values))
        run.attempted, run.failed = steps, 0
        run.memory_peak_bytes = (torch.cuda.max_memory_allocated(dev)
                                 if cuda else 0)
        run.note(f"window {run.window_s:.3f} s: {steps} steps, "
                 f"{audio_s:.1f} s of audio; peak device memory "
                 f"{run.memory_peak_bytes} bytes; fused_frontend launches "
                 f"{cuda_frontend.fused_frontend.launches - launches}")
        del ts, model, feed, loader
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        check(run, plain, w, first, keys, losses, first_grad, change)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check(run, plain, w, first, keys, losses, first_grad, change) -> None:
    values = run.values
    batches, unknown = [], 0
    for audio, lens, y, _ in first:
        audio = audio.reshape(audio.shape[0], -1)
        host = audio.cpu().numpy()
        for row, n in zip(host, lens.cpu().numpy()):
            unknown += (int(n), row[:16].tobytes()) not in keys
        batches.append((audio, lens, y))
    got = plain.train_steps(w, values, batches)
    gaps = compare(losses, first_grad, change, got)
    run.note(f"reference losses {got['loss']}")
    ctrl = None
    if run.control:
        ctrl = compare(got["loss"], got["first_grad"], got["change"],
                       plain.train_steps(w, values, batches, tf32=True))
    run.check("unknown_rows", float(unknown), 0.0 if run.control else None)
    # the mix's limits say which of compare's numbers the cell holds
    names = set(run.mix["check"]["limits"]) - {"unknown_rows"}
    if not names or names - set(gaps):
        raise ValueError(f"the mix's check names {sorted(names)}; "
                         f"compare gives {sorted(gaps)}")
    for name in (n for n in gaps if n in names):
        run.check(name, gaps[name], ctrl[name] if ctrl else None)


def compare(losses, first_grad, change, got) -> dict:
    """`loss`: the worst relative gap of the steps' losses; `first_loss`:
    the first step's alone; `first_grad`, `change`: leaf_gap's."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, got["loss"])]
    return {"loss": max(gaps), "first_loss": gaps[0],
            "first_grad": leaf_gap(first_grad, got["first_grad"],
                                   got["raw_grad"]),
            "change": leaf_gap(change, got["change"], got["raw_grad"])}
