"""Evaluation replicas in worker processes (the port's counterpart of the
JAX package's eval mesh over jax.devices(): parallel/mesh.py,
place_eval_params and place_data_batch in parallel/sharding.py).

JAX places one replica per run of num_partitions devices and splits each
batch along 'data' inside one program.  The port's decoders are
host-bound Python loops (one sync and tens of launches a step), so
replicas on threads of one process queue on the interpreter lock; here
each replica beyond the first is a worker process of its own:

    pool = EvalPool(mesh, cfg, model, lm, lm_cfg)    # or `with EvalPool(...)`
    logits, y_hat = pool.run_split("greedy", (feats, featlen))
    future = pool.submit("featurize_then_beam", (audio, lens), beam_size=8)
    pool.close()

- Start-up, once per entry point: the parent loads the fused frontend
  kernel (so N workers do not each run nvcc) and starts one process per
  replica with the `spawn` context (CUDA in the parent forbids fork).
  Each receives the Config, the LAS state dict and, where there is one,
  the LM's state dict and LMConfig, as CPU tensors, once; rebuilds the
  model with the port's constructors (int8 cells quantized before the
  state is loaded, so keys and dtypes match), places it on its devices
  (split over them by sharding.place_eval_params when num_partitions > 1)
  and loads the kernel.  Its stdout goes to stderr, so the entry points'
  own lines stay theirs.
- Operations are named (OPS): featurize, greedy (attention or CTC best
  path, by cfg.eval_decoder or `decoder`), beam (with the LM and joint
  CTC by cfg), featurize_then_greedy / featurize_then_beam for raw audio,
  and state_dict.  Greedy and beam take max_steps from the batch's padded
  width, max(int(convert_rate * T), 1), unless `steps` is given.
  Models run under las.compute_cast inside the decoders.
- run_split(op, arrays) cuts one batch's rows into a chunk per replica,
  each at the batch's full width, runs them at once and gathers them in
  row order on the first device (JAX's place_data_batch semantics; rows
  must divide by the replicas: sharding.pad_batch_to).
  submit(op, arrays) runs a whole batch on the next free worker and
  returns a concurrent.futures.Future, so a loop keeps N batches in
  flight; the future's `seconds` is its submit-to-result wall time.
  Inputs and outputs cross as CPU tensors.
- One replica runs inline on the caller's thread and device, with no
  process: the one-GPU path is the one it was.
- Failures: an exception in a worker reaches the caller as
  utils/platform.WorkerError with the worker's message and traceback; a
  worker that dies (EOF on its pipe) fails its job and every later one
  with WorkerLost, which the entry points exit 18 on.  close() (or the
  context manager, or interpreter exit) stops every worker process.
- `launches` sums the fused frontend kernel launches the workers report
  with each result (an inline replica counts in this process's own
  cuda_frontend.fused_frontend.launches); describe() gives each
  replica's devices and split.
"""

from __future__ import annotations

import contextlib
import logging
import multiprocessing as mp
import os
import pickle
import queue
import signal
import sys
import threading
import time
import traceback
import weakref
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..decoding import beam as beam_lib
from ..decoding.ctc import ctc_greedy_decode
from ..models import char_rnn
from ..models.las import LAS
from ..ops import _kernels, cuda_frontend, quant
from ..ops import frontend as fe
from ..training import trainer
from ..utils import spans
from ..utils.device import host_tensor
from ..utils.platform import WorkerError, WorkerLost
from ..utils.tokenizer import EOS_ID
from . import sharding
from . import tensor_parallel as tp
from .mesh import Mesh

log = logging.getLogger(__name__)

# seconds a worker may take to start (interpreter, torch, CUDA context,
# model build) and to stop once asked
START_TIMEOUT_S = 600.0
STOP_TIMEOUT_S = 30.0
_PICKLE = pickle.HIGHEST_PROTOCOL


# ---------------------------------------------------------------- the ops


@dataclass
class Loaded:
    """What an operation runs on: a sharding.Replica with the config and
    the LM's config."""
    replica: sharding.Replica
    cfg: Config
    lm_cfg: Any = None

    @property
    def model(self) -> nn.Module:
        return self.replica.model

    def max_steps(self, feats: torch.Tensor, steps: Optional[int]) -> int:
        return steps or max(int(self.cfg.convert_rate * feats.shape[1]), 1)


def featurize(r: Loaded, audio: torch.Tensor, lens: torch.Tensor,
              frontend: str = "signals"):
    """Raw audio rows -> (feats, featlen): 'signals' as
    api.Recognizer._features (ops/frontend.extract_features_cfg), 'batch'
    as the loader's batches (ops/frontend.featurize_batch); a
    `recognizer.featurize` span (utils/spans.py)."""
    with spans.span("recognizer.featurize"):
        if frontend == "batch":
            return fe.featurize_batch(audio, lens, r.cfg)
        return fe.extract_features_cfg(audio, lens, r.cfg)


def greedy(r: Loaded, feats: torch.Tensor, featlen: torch.Tensor,
           steps: Optional[int] = None, decoder: Optional[str] = None,
           logits: bool = True):
    """(logits or None, tokens): the greedy speller
    (training/trainer.eval_forward) or, for decoder 'ctc_greedy', the
    best CTC path padded with <EOS> (no logits)."""
    if (decoder or r.cfg.eval_decoder) == "ctc_greedy":
        toks, lens = ctc_greedy_decode(r.model, feats, featlen, r.cfg)
        # pad the collapsed ids with <EOS> so detokenization cuts there
        # even when the CTC path never emits one itself
        pos = torch.arange(toks.shape[1], device=toks.device)
        return None, torch.where(pos[None, :] < lens[:, None], toks, EOS_ID)
    out, y_hat = trainer.eval_forward(r.model, feats, featlen, r.cfg,
                                      r.max_steps(feats, steps))
    return (out if logits else None), y_hat


def beam(r: Loaded, feats: torch.Tensor, featlen: torch.Tensor,
         beam_size: int, steps: Optional[int] = None):
    """decoding/beam.beam_search with cfg's beam flags and the LM."""
    return beam_lib.beam_search(r.model, feats, featlen, r.cfg,
                                r.max_steps(feats, steps), beam_size,
                                r.cfg.beam_logprob, r.replica.lm, r.lm_cfg)


def featurize_then_greedy(r: Loaded, audio, lens, frontend="signals", **kw):
    return greedy(r, *featurize(r, audio, lens, frontend), **kw)


def featurize_then_beam(r: Loaded, audio, lens, beam_size: int,
                        frontend="signals", **kw):
    return beam(r, *featurize(r, audio, lens, frontend), beam_size, **kw)


def state_dict(r: Loaded):
    """(the model's whole state dict, the LM's or None)."""
    lm = r.replica.lm
    return (sharding.whole_state_dict(r.model),
            sharding.whole_state_dict(lm) if lm is not None else None)


OPS: Dict[str, Callable] = {
    f.__name__: f for f in (featurize, greedy, beam, featurize_then_greedy,
                            featurize_then_beam, state_dict)}


def _run(r: Loaded, op: str, args: Sequence, kwargs: Dict) -> Any:
    if op not in OPS:
        raise KeyError(f"unknown eval op {op!r} (want one of {sorted(OPS)})")
    device = r.replica.device
    args = [host_tensor(a) if isinstance(a, np.ndarray) else a
            for a in args]
    args = [a.to(device) if torch.is_tensor(a) else a for a in args]
    guard = (torch.cuda.device(device) if device.type == "cuda"
             else contextlib.nullcontext())
    with guard, torch.no_grad():
        return OPS[op](r, *args, **kwargs)


def _to_host(x: Any) -> Any:
    if torch.is_tensor(x):
        return x.detach().cpu()
    if isinstance(x, tuple):
        items = [_to_host(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def describe_replica(r: Loaded) -> Dict[str, Any]:
    axis = tp.model_axis(r.model)
    return {"devices": [str(d) for d in
                        (axis.devices if isinstance(axis, tp.DeviceAxis)
                         else [r.replica.device])],
            "split": axis.size if axis is not None else 1}


# ------------------------------------------------------------- the worker


@dataclass
class Spec:
    """What a worker rebuilds its replica from (CPU tensors), and the
    parent's numeric settings."""
    cfg: Config
    model: Dict[str, torch.Tensor]
    quantized: bool
    lm: Optional[Dict[str, torch.Tensor]] = None
    lm_cfg: Any = None
    lm_quantized: bool = False
    tf32: tuple = (False, False, False)


def _is_quantized(module: nn.Module) -> bool:
    return any(isinstance(m, quant.QuantLinear) for m in module.modules())


def build_replica(spec: Spec, devices: Sequence[torch.device]) -> Loaded:
    """The replica a worker holds: the port's constructors, int8 cells
    quantized before the state dict is loaded, placed (and split) over
    `devices`."""
    cfg = spec.cfg
    model = LAS(cfg)
    if spec.quantized:
        model = quant.maybe_quantize(model, cfg.replace(
            quantize_decoder="int8"))
    model.load_state_dict(spec.model)
    lm = None
    if spec.lm is not None:
        lm = char_rnn.CharRNN(spec.lm_cfg)
        if spec.lm_quantized:
            lm = quant.quantize_lm(lm, spec.lm_cfg)
        lm.load_state_dict(spec.lm)
    mesh = Mesh(list(devices), None, num_partitions=len(devices))
    return Loaded(sharding.place_eval_params(mesh, model, lm)[0], cfg,
                   spec.lm_cfg)


def _send(conn, obj) -> None:
    conn.send_bytes(pickle.dumps(obj, _PICKLE))


def _error(exc: BaseException) -> tuple:
    return ("err", type(exc).__name__, str(exc), traceback.format_exc())


def worker_main(conn, devices: List[str], threads: int) -> None:
    """A worker process: build the replica from the first message, then
    answer ("run", op, args, kwargs) messages until None or EOF."""
    os.dup2(2, 1)                      # stdout belongs to the parent
    sys.stdout = sys.stderr
    signal.signal(signal.SIGINT, signal.SIG_IGN)   # the parent stops us
    torch.set_num_threads(threads)
    try:
        t0 = time.perf_counter()
        spec: Spec = pickle.loads(conn.recv_bytes())
        devs = [torch.device(d) for d in devices]
        if devs[0].type == "cuda":
            torch.cuda.set_device(devs[0])
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul
             .allow_bf16_reduced_precision_reduction) = spec.tf32
            if spec.cfg.use_pallas:
                _kernels.load("fused_frontend")
        r = build_replica(spec, devs)
        del spec
        _send(conn, ("ready", describe_replica(r), os.getpid(),
                     time.perf_counter() - t0))
    except BaseException as e:     # noqa: BLE001 — reported, then exit
        _send(conn, _error(e))
        return
    while True:
        try:
            msg = conn.recv_bytes()
        except (EOFError, OSError):
            return                     # the parent is gone
        msg = pickle.loads(msg)
        if msg is None:
            return
        _, op, args, kwargs = msg
        before = cuda_frontend.fused_frontend.launches
        try:
            out = _to_host(_run(r, op, args, kwargs))
            if devs[0].type == "cuda":
                torch.cuda.synchronize()
            reply = ("ok", out,
                     cuda_frontend.fused_frontend.launches - before)
        except Exception as e:     # noqa: BLE001 — the caller's to judge
            reply = _error(e)
        _send(conn, reply)


# ------------------------------------------------------------- the parent


class _Shared:
    """State the pool's threads share: the first lost worker and the
    kernel launches reported."""

    def __init__(self):
        self.lock = threading.Lock()
        self.lost: Optional[WorkerLost] = None
        self.launches = 0


class _Worker:
    """One worker process, its pipe, and the thread that feeds it jobs
    one at a time."""

    def __init__(self, ctx, index: int, devices: List[torch.device],
                 threads: int, shared: _Shared):
        self.index, self.devices, self.shared = index, devices, shared
        self.where = (f"eval worker {index} on "
                      f"{','.join(map(str, devices))}")
        parent, child = ctx.Pipe()
        self.proc = ctx.Process(
            target=worker_main, args=(child, [str(d) for d in devices],
                                      threads),
            name=f"eval-worker-{index}", daemon=True)
        self.proc.start()
        child.close()
        self.conn = parent
        self.jobs: "queue.Queue" = queue.Queue()
        self.outstanding = 0               # guarded by shared.lock
        self.info: Dict[str, Any] = {}
        self.thread: Optional[threading.Thread] = None

    def _recv(self):
        try:
            return pickle.loads(self.conn.recv_bytes())
        except (EOFError, OSError) as e:
            self.proc.join(1.0)
            raise WorkerLost(self.where, self.proc.pid,
                             self.proc.exitcode) from e

    def ready(self, timeout: float) -> float:
        """Wait for the worker's replica; its start-up seconds."""
        if not self.conn.poll(timeout):
            raise RuntimeError(f"{self.where} did not start in {timeout} s")
        reply = self._recv()
        if reply[0] != "ready":
            raise WorkerError(self.where, *reply[1:])
        self.info = {**reply[1], "pid": reply[2]}
        self.thread = threading.Thread(target=self._serve, daemon=True,
                                       name=f"eval-feeder-{self.index}")
        self.thread.start()
        return reply[3]

    def _call(self, op: str, args, kwargs) -> tuple:
        """(outputs, None) or (None, the exception) of one job."""
        if self.shared.lost is not None:
            return None, self.shared.lost
        try:
            _send(self.conn, ("run", op, args, kwargs))
            reply = self._recv()
        except (WorkerLost, OSError) as e:
            lost = (e if isinstance(e, WorkerLost) else WorkerLost(
                self.where, self.proc.pid, self.proc.exitcode))
            self.shared.lost = self.shared.lost or lost
            return None, lost
        except Exception as e:     # noqa: BLE001 — e.g. an unpicklable arg
            return None, e
        if reply[0] == "ok":
            with self.shared.lock:
                self.shared.launches += reply[2]
            return reply[1], None
        return None, WorkerError(f"{self.where}, op {op!r}", *reply[1:])

    def _serve(self) -> None:
        while True:
            job = self.jobs.get()
            if job is None:
                return
            fut, op, args, kwargs, t0 = job
            live = fut.set_running_or_notify_cancel()
            out, error = self._call(op, args, kwargs) if live else (None,
                                                                    None)
            # free before the caller wakes: a job it submits on this
            # result must see this worker idle, not queue behind a busy one
            with self.shared.lock:
                self.outstanding -= 1
            if not live:
                continue
            fut.seconds = time.perf_counter() - t0
            if error is not None:
                fut.set_exception(error)
            else:
                fut.set_result(out)


def _stop(workers: List[_Worker]) -> None:
    """Stop every worker: cancel queued jobs, let each finish the one it
    runs, ask it to exit, then terminate and kill what is left."""
    for w in workers:
        while True:
            try:
                job = w.jobs.get_nowait()
            except queue.Empty:
                break
            if job is not None:
                job[0].cancel()
        w.jobs.put(None)
    deadline = time.monotonic() + STOP_TIMEOUT_S
    for w in workers:
        if w.thread is not None:
            w.thread.join(max(deadline - time.monotonic(), 0.1))
        if w.thread is None or not w.thread.is_alive():
            try:
                _send(w.conn, None)
            except OSError:
                pass
    for w in workers:
        w.proc.join(max(deadline - time.monotonic(), 0.1))
        if w.proc.is_alive():
            w.proc.terminate()
            w.proc.join(5.0)
        if w.proc.is_alive():
            w.proc.kill()
            w.proc.join()
        w.conn.close()


def done(fn: Callable[[], Any]) -> Future:
    """A finished Future holding fn()'s result or exception."""
    fut: Future = Future()
    t0 = time.perf_counter()
    try:
        fut.set_result(fn())
    except Exception as e:     # noqa: BLE001 — the caller's to judge
        fut.set_exception(e)
    fut.seconds = time.perf_counter() - t0
    return fut


def then(fut: Future, fn: Callable[[Any], Any]) -> Future:
    """A Future of fn(fut's result), or of fut's exception; `seconds` is
    fut's."""
    out: Future = Future()

    def finish(f: Future) -> None:
        try:
            if f.cancelled():
                out.cancel()
                return
            out.seconds = getattr(f, "seconds", None)
            e = f.exception()
            if e is not None:
                out.set_exception(e)
            else:
                out.set_result(fn(f.result()))
        except Exception as e:     # noqa: BLE001 — fn's failure
            out.set_exception(e)

    fut.add_done_callback(finish)
    return out


class EvalPool:
    """The replicas of an evaluation mesh: one inline, or one worker
    process each (see the module docstring)."""

    def __init__(self, mesh: Mesh, cfg: Config, model: nn.Module,
                 lm: Optional[nn.Module] = None, lm_cfg: Any = None):
        self.mesh, self.cfg = mesh, cfg
        self.device = mesh.devices[0]
        groups = mesh.replica_devices()
        self.size = len(groups)
        self.startup_s = 0.0
        self._shared = _Shared()
        self._workers: List[_Worker] = []
        self._closed = False
        self._inline: Optional[Loaded] = None
        if self.size == 1:
            self._inline = Loaded(
                sharding.place_eval_params(mesh, model, lm)[0], cfg, lm_cfg)
            return
        t0 = time.perf_counter()
        if any(d.type == "cuda" for d in mesh.devices) and cfg.use_pallas:
            _kernels.load("fused_frontend")    # built once, loaded by all
        spec = pickle.dumps(Spec(
            cfg, _host_state(model), _is_quantized(model),
            _host_state(lm) if lm is not None else None, lm_cfg,
            lm is not None and _is_quantized(lm),
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul
             .allow_bf16_reduced_precision_reduction)), _PICKLE)
        threads = max(1, torch.get_num_threads() // self.size)
        ctx = mp.get_context("spawn")
        try:
            for i, devs in enumerate(groups):
                self._workers.append(_Worker(ctx, i, devs, threads,
                                             self._shared))
            for w in self._workers:
                w.conn.send_bytes(spec)
            seconds = [w.ready(START_TIMEOUT_S) for w in self._workers]
        except BaseException:
            _stop(self._workers)
            raise
        self._finalizer = weakref.finalize(self, _stop, self._workers)
        self.startup_s = time.perf_counter() - t0
        log.info("%d eval workers up in %.1f s (each %s s): %s", self.size,
                 self.startup_s, [round(s, 1) for s in seconds],
                 self.describe())

    # -- lifecycle -----------------------------------------------------

    def close(self) -> None:
        """Stop every worker process (idempotent)."""
        if self._closed:
            return
        self._closed = True
        if self._workers:
            self._finalizer()

    def __enter__(self) -> "EvalPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- what it holds -------------------------------------------------

    @property
    def launches(self) -> int:
        """Fused frontend launches the workers reported."""
        return self._shared.launches

    @launches.setter
    def launches(self, value: int) -> None:
        self._shared.launches = value

    def describe(self) -> List[Dict[str, Any]]:
        """Each replica's devices, split (the size of the model axis its
        layers are split over, 1 if whole) and process id (None:
        inline)."""
        if self._inline is not None:
            return [{**describe_replica(self._inline), "pid": None}]
        return [dict(w.info) for w in self._workers]

    # -- running -------------------------------------------------------

    def submit(self, op: str, arrays: Sequence[Any],
               worker: Optional[int] = None, **kwargs) -> Future:
        """op on a whole batch, on `worker` or on the one with the fewest
        jobs (its index is the Future's `worker`); a Future of its
        outputs (CPU tensors from a worker, the device's inline)."""
        if self._inline is not None:
            return done(lambda: _run(self._inline, op, list(arrays),
                                      kwargs))
        args = [host_tensor(a) if isinstance(a, np.ndarray) else
                a.cpu() if torch.is_tensor(a) else a for a in arrays]
        fut: Future = Future()
        with self._shared.lock:
            if self._closed:
                raise RuntimeError("the eval pool is closed")
            w = (self._workers[worker] if worker is not None else
                 min(self._workers, key=lambda w: w.outstanding))
            w.outstanding += 1
            fut.worker = w.index
            w.jobs.put((fut, op, args, kwargs, time.perf_counter()))
        return fut

    def run_split(self, op: str, arrays: Sequence[Any], **kwargs) -> Any:
        """op on one batch whose rows are split over the replicas (dim 0
        must divide by them), gathered in row order on the first
        device."""
        if self._inline is not None:
            return self.submit(op, arrays, **kwargs).result()
        chunks = sharding.split_rows(arrays, self.size)
        futures = [self.submit(op, c, worker=i, **kwargs)
                   for i, c in enumerate(chunks)]
        return sharding.gather_rows([f.result() for f in futures],
                                    self.device)


def _host_state(module: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


@contextlib.contextmanager
def exit_on_sigterm() -> Iterator[None]:
    """Within it, in the main thread, SIGTERM raises SystemExit(143), so
    an entry point's `with` blocks and finally clauses close its pool;
    the previous handler comes back after."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return
    previous = signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        yield
    finally:
        signal.signal(signal.SIGTERM, previous)
