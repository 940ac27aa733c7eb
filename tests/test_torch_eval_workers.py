"""Evaluation replicas in worker processes (automatic_speech_recognition_
torch/parallel/workers.py) on the CPU, at small_cfg widths: a mesh that
lists the CPU twice runs two spawned worker processes.

- A worker rebuilds the parent's model key by key (float32, bf16 masters,
  int8 cells and a quantized LM, a replica split over two positions),
  with BN statistics, the zero bias_hh buffers and an edited bias.
- run_split and submit give greedy tokens and beam rank 0 (fusion LM and
  joint CTC) equal to one device, logits and scores within 1e-5.
- A worker featurizes its rows as the first device does (1e-6, the
  plain frontend), and the Recognizer over two workers transcribes as
  one device does.
- The pool over 'cpu,cpu' gives the JAX package's mesh eval over two
  virtual CPU devices (tests/test_sharding.py's way): greedy tokens
  equal, logits within 1e-5; beam rank 0 equal, scores within 1e-4.
- A worker's exception reaches the caller with its message and
  traceback, and the test entry point skips that batch and counts it; a
  worker killed with SIGKILL raises WorkerLost and the entry point exits
  18; close() leaves no worker process.
- A batch goes to a free worker, never behind a busy one while another
  is idle (three workers, one long batch).
- BatchingRecognizer over two workers answers 16 concurrent requests
  with one device's texts and counts them; the serve and transcribe
  entry points over '--device cpu,cpu' give one device's texts, and
  serve's /healthz lists both workers.
"""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import json
import multiprocessing as mp
import os
import queue
import signal
import subprocess
import sys
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from automatic_speech_recognition_tpu.decoding import beam as jbeam
from automatic_speech_recognition_tpu.parallel import sharding as jsh
from automatic_speech_recognition_tpu.parallel.mesh import \
    make_mesh as jmake_mesh
from automatic_speech_recognition_tpu.training import trainer as jtrainer
from automatic_speech_recognition_torch import serve as serve_cli
from automatic_speech_recognition_torch import test as test_cli
from automatic_speech_recognition_torch import transcribe as transcribe_cli
from automatic_speech_recognition_torch.api import Recognizer
from automatic_speech_recognition_torch.models import char_rnn as tcr
from automatic_speech_recognition_torch.models import convert
from automatic_speech_recognition_torch.models import las as tlas
from automatic_speech_recognition_torch.ops import quant
from automatic_speech_recognition_torch.parallel import workers
from automatic_speech_recognition_torch.parallel.mesh import make_mesh
from automatic_speech_recognition_torch.serving import BatchingRecognizer
from automatic_speech_recognition_torch.training.checkpoint import (
    CheckpointManager)
from automatic_speech_recognition_torch.utils.platform import (
    WorkerError, WorkerLost, exit_for_transient_errors)
from automatic_speech_recognition_torch.utils.tokenizer import (CharEncoder,
                                                               EOS_ID)

from test_torch_decode_cli import MODEL_FLAGS, _wavs, assets  # noqa: F401
from test_torch_las import jax_cfg, jax_model, small_cfg
from test_torch_serve import FLAGS as SERVE_FLAGS

CPU = torch.device("cpu")
ONE = make_mesh(devices=[CPU])
TWO = make_mesh(devices=[CPU, CPU])
SR = 16000


def _lm(seed=1):
    lm_cfg = tcr.LMConfig(vocab_size=28, hidden_size=16, num_layers=2,
                          model="lstm", embedding_size=8)
    return tcr.init(lm_cfg, torch.Generator().manual_seed(seed), CPU), lm_cfg


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    audio = torch.from_numpy(
        rng.standard_normal((8, 32, 13, 3)).astype(np.float32))
    audiolen = torch.tensor([32, 30, 28, 32, 17, 32, 25, 32],
                            dtype=torch.int32)
    return audio, audiolen


def _signals(seed=3, n=5):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(int(rng.integers(4000, 15000))) * 0.1)
            .astype(np.float32) for _ in range(n)]


@pytest.fixture(scope="module")
def recs():
    """(one, two): Recognizers of one model with a CTC head and a fusion
    LM, on one CPU device (inline) and over 'cpu,cpu' (two workers)."""
    cfg = small_cfg(ctc=True, beam_logprob=True, ctc_beam_weight=0.5,
                    lm_weight=0.5)
    model = tlas.init(cfg, torch.Generator().manual_seed(0), CPU)
    lm, lm_cfg = _lm()
    one = Recognizer(model, cfg, CharEncoder(), "cpu", lm, lm_cfg)
    two = Recognizer(model, cfg, CharEncoder(), "cpu,cpu", lm, lm_cfg)
    yield one, two
    two.close()


def _assert_same_state(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k], v.cpu()), k


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8", "tp2"])
def test_worker_state_dicts_equal_the_parents(kind):
    """Every worker's rebuilt model (and LM) against the parent's, key by
    key: BN statistics moved off their init, the zero bias_hh buffers,
    an EOS bias lowered in memory, int8 q / w_scale buffers, and at
    num_partitions 2 (four positions, two replicas) the split layers
    gathered whole."""
    cfg = small_cfg(apply_bn=True, dtype=kind if kind == "bfloat16"
                    else "float32",
                    quantize_decoder="int8" if kind == "int8" else "none")
    model = tlas.init(cfg, torch.Generator().manual_seed(0), CPU)
    with torch.no_grad():
        model.listener.layers[0].bn_main.mean.add_(0.5)
        model.speller.out.bias[EOS_ID] -= 20.0
    lm, lm_cfg = _lm()
    if kind == "int8":
        model, lm = quant.maybe_quantize(model, cfg), quant.quantize_lm(
            lm, lm_cfg)
    mesh = (make_mesh(devices=[CPU] * 4, num_partitions=2) if kind == "tp2"
            else TWO)
    assert any(k.endswith("bias_hh_l0") for k in model.state_dict())
    with workers.EvalPool(mesh, cfg, model, lm, lm_cfg) as pool:
        info = pool.describe()
        assert [d["split"] for d in info] == [2 if kind == "tp2" else 1] * 2
        assert all(d["pid"] not in (None, os.getpid()) for d in info)
        for i in range(pool.size):
            got, got_lm = pool.submit("state_dict", (), worker=i).result()
            _assert_same_state(got, model.state_dict())
            _assert_same_state(got_lm, lm.state_dict())
            if kind == "int8":
                assert got["speller.cells.0.q"].dtype == torch.int8


def test_run_split_and_submit_match_one_device(recs):
    one, two = recs
    audio, audiolen = _batch()
    want_logits, want = one.pool.run_split("greedy", (audio, audiolen),
                                           steps=10)
    for got_logits, got in (
            two.pool.run_split("greedy", (audio, audiolen), steps=10),
            two.pool.submit("greedy", (audio, audiolen), steps=10).result()):
        torch.testing.assert_close(got_logits, want_logits, rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(got, want)
    want = one.pool.run_split("beam", (audio, audiolen), beam_size=4,
                              steps=10)
    fut = two.pool.submit("beam", (audio, audiolen), beam_size=4, steps=10)
    for got in (two.pool.run_split("beam", (audio, audiolen), beam_size=4,
                                   steps=10), fut.result()):
        assert torch.equal(got.tokens[:, 0], want.tokens[:, 0])
        assert torch.equal(got.lengths, want.lengths)
        torch.testing.assert_close(got.scores, want.scores, rtol=1e-5,
                                   atol=1e-5)
    assert fut.seconds > 0


def test_featurize_in_the_workers_equals_the_first_device(recs):
    one, two = recs
    sigs = _signals() + [np.zeros(1, np.float32)]
    feats, featlen = two._features(sigs, pad_seconds=2)
    got, got_len = two.pool.run_split("featurize", two._audio(sigs, 2))
    torch.testing.assert_close(got, feats, rtol=0, atol=1e-6)
    assert torch.equal(got_len, featlen)
    for beam_size in (0, 4):
        assert two.transcribe_signals(sigs[:5], beam_size) == \
            one.transcribe_signals(sigs[:5], beam_size)


def test_the_pool_matches_the_jax_mesh_eval(rng):
    """Converted JAX parameters: the pool over 'cpu,cpu' against the JAX
    package's place_eval_params / place_data_batch over two virtual CPU
    devices, greedy and beam 4 with joint CTC."""
    cfg = small_cfg(ctc=True, beam_logprob=True, ctc_beam_weight=0.5)
    params, state = jax_model(cfg, rng)
    audio, audiolen = (t.numpy() for t in _batch())
    jmesh = jmake_mesh(num_devices=2, num_partitions=1)
    p, b = jsh.place_eval_params(jmesh, params, state)
    a_d, l_d = jsh.place_data_batch(jmesh, (audio, audiolen))
    jlogits, jy = jtrainer.eval_forward(p, b, a_d, l_d, jax_cfg(cfg),
                                        dec_steps=10)
    jres = jbeam.beam_search(p, b, a_d, l_d, jax_cfg(cfg), max_steps=10,
                             beam_size=4, logprob=True)
    model = convert.from_jax_params(params, state, cfg, CPU)
    with workers.EvalPool(TWO, cfg, model) as pool:
        logits, y = pool.run_split("greedy", (audio, audiolen), steps=10)
        res = pool.run_split("beam", (audio, audiolen), beam_size=4,
                             steps=10)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(res.tokens[:, 0].numpy(),
                                  np.asarray(jres.tokens)[:, 0])
    np.testing.assert_array_equal(res.lengths[:, 0].numpy(),
                                  np.asarray(jres.lengths)[:, 0])
    np.testing.assert_allclose(res.scores[:, 0].numpy(),
                               np.asarray(jres.scores)[:, 0], rtol=1e-4)


def _test_flags(d, log_dir):
    return ["--device", "cpu,cpu"] + MODEL_FLAGS + [
        "--shard_dir", d, "--split", "dev", "--save_dir", d + "/model",
        "--log_dir", log_dir, "--bucket_batch_sizes",
        ",".join(["2"] * 9)]


def _gone(pids):
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_a_worker_error_reaches_the_caller_and_test_skips_it(
        recs, assets, monkeypatch):  # noqa: F811
    _, two = recs
    audio, audiolen = _batch()
    with pytest.raises(WorkerError, match="RuntimeError in eval worker"
                       ) as e:
        two.pool.submit("greedy", (audio[..., 0], audiolen)).result()
    assert "traceback in the worker" in str(e.value)
    assert "eval_forward" in e.value.traceback
    # the test entry point: three batches of two over two workers, the
    # second sent to an op no worker has
    calls, pids = [], []
    submit = workers.EvalPool.submit

    def second_fails(self, op, arrays, worker=None, **kw):
        calls.append(op)
        pids[:] = [d["pid"] for d in self.describe()]
        return submit(self, "no_such_op" if len(calls) == 2 else op,
                      arrays, worker, **kw)

    monkeypatch.setattr(workers.EvalPool, "submit", second_fails)
    res = test_cli.main(_test_flags(assets, assets + "/log_skip"))
    assert len(calls) == 3 and res.batches == 2
    assert res.skipped == 2 and res.utterances == 4
    _gone(pids)


def test_a_killed_worker_raises_worker_lost_and_exits_18(
        recs, assets, monkeypatch):  # noqa: F811
    pids = []
    submit = workers.EvalPool.submit

    def kill_first(self, op, arrays, worker=None, **kw):
        if not pids:
            pids[:] = [d["pid"] for d in self.describe()]
            for w in self._workers:
                os.kill(w.proc.pid, signal.SIGKILL)
                w.proc.join()
        return submit(self, op, arrays, worker, **kw)

    monkeypatch.setattr(workers.EvalPool, "submit", kill_first)
    with pytest.raises(SystemExit) as e:
        exit_for_transient_errors(test_cli.main,
                                  _test_flags(assets, assets + "/log_kill"))
    assert e.value.code == 18 and len(pids) == 2
    _gone(pids)
    # the pool's own call raises WorkerLost
    cfg = small_cfg()
    pool = workers.EvalPool(TWO, cfg, tlas.init(
        cfg, torch.Generator().manual_seed(0), CPU))
    os.kill(pool.describe()[1]["pid"], signal.SIGKILL)
    with pytest.raises(WorkerLost, match="eval worker 1 on cpu"):
        pool.run_split("greedy", _batch(), steps=4)
    with pytest.raises(WorkerLost):       # and every later call
        pool.submit("greedy", _batch(), worker=0, steps=4).result()
    pool.close()


def test_the_next_batch_goes_to_a_free_worker_not_a_busy_one():
    """Three workers, a long batch held by worker 0, and two chains of
    short batches beside it, each sending its next batch from the done
    callback of the one before (as the batcher's _finish frees a slot):
    a worker counts as free before its result wakes anyone, so no short
    batch queues behind the long one while another worker is idle."""
    cfg = small_cfg()
    with workers.EvalPool(make_mesh(devices=[CPU] * 3), cfg, tlas.init(
            cfg, torch.Generator().manual_seed(0), CPU)) as pool:
        slow = pool.submit("greedy", _batch(), worker=0, steps=8000)
        sent, lock, finished = [], threading.Lock(), threading.Semaphore(0)

        def chain(left):
            fut = pool.submit("greedy", _batch(), steps=4)
            with lock:
                sent.append((fut.worker, slow.done()))
            fut.add_done_callback(lambda f: chain(left - 1) if left > 1
                                  else finished.release())

        chain(8)
        chain(8)
        assert finished.acquire(timeout=120) and finished.acquire(timeout=120)
        slow.result()
    early = [w for w, slow_done in sent if not slow_done]
    assert len(sent) == 16 and len(early) >= 8
    assert 0 not in early, sent


def test_close_leaves_no_child_process():
    cfg = small_cfg()
    pool = workers.EvalPool(TWO, cfg, tlas.init(
        cfg, torch.Generator().manual_seed(0), CPU))
    pids = [d["pid"] for d in pool.describe()]
    assert {p.pid for p in mp.active_children()} >= set(pids)
    pool.close()
    pool.close()                         # idempotent
    assert not {p.pid for p in mp.active_children()} & set(pids)
    _gone(pids)
    with pytest.raises(RuntimeError, match="closed"):
        pool.submit("greedy", _batch())


_SIGTERM_SCRIPT = r"""
import sys, time, torch
from automatic_speech_recognition_torch.config import Config
from automatic_speech_recognition_torch.models import las
from automatic_speech_recognition_torch.parallel import workers
from automatic_speech_recognition_torch.parallel.mesh import make_mesh
if __name__ == "__main__":
    cfg = Config(unit="char", vocab_size=30, feat_dim=13, enc_units=16,
                 num_enc_channels=4, num_enc_layers=1, dec_units=16,
                 num_dec_layers=1, embedding_size=8, attention_size=8)
    cpu = torch.device("cpu")
    try:
        with workers.exit_on_sigterm(), workers.EvalPool(
                make_mesh(devices=[cpu, cpu]), cfg, las.LAS(cfg)) as pool:
            print(*[d["pid"] for d in pool.describe()], flush=True)
            time.sleep(120)
    finally:
        print("closed", flush=True)
"""


def test_sigterm_in_an_entry_point_closes_the_pool(tmp_path):
    """exit_on_sigterm: SIGTERM to a process holding a pool exits it with
    143 through its `with` blocks, and no worker process is left."""
    script = tmp_path / "hold_pool.py"
    script.write_text(_SIGTERM_SCRIPT)
    proc = subprocess.Popen([sys.executable, str(script)], env={
        **os.environ, "PYTHONPATH": os.pathsep.join(sys.path)},
        stdout=subprocess.PIPE, text=True)
    try:
        pids = [int(p) for p in proc.stdout.readline().split()]
        assert len(pids) == 2
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=60)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 143 and "closed" in out
    _gone(pids)


def test_the_batcher_over_two_workers_matches_one_device(recs):
    one, two = recs
    sigs = _signals(seed=5, n=16)
    futures = [None] * 16
    with BatchingRecognizer(two, max_batch=4, max_wait_ms=20,
                            bucket_seconds=(1, 2)) as srv:
        assert srv.replicas == 2
        srv.warmup()

        def client(k):
            for i in range(k, 16, 4):
                futures[i] = srv.submit(sigs[i])

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        texts = [f.result(timeout=120) for f in futures]
    snap = srv.stats.snapshot()
    assert snap["requests"] == 16 and snap["errors"] == 0
    assert snap["batches"] >= 4 and snap["mean_queue_wait_ms"] >= 0
    for s, text in zip(sigs, texts):
        b = 1 if len(s) <= SR else 2
        assert text == one.transcribe_signals([s] * 4, pad_seconds=b)[0]


def test_serve_and_transcribe_over_two_workers_match_one_device(
        assets, tmp_path):  # noqa: F811
    """serve.main over 'cpu,cpu' (warmup on both workers): /healthz lists
    the two worker processes and 4 concurrent requests get one device's
    texts; transcribe over 'cpu,cpu' (beam 3, LM, joint CTC) prints one
    device's lines."""
    cfg = small_cfg(max_audio_seconds=4)
    model = tlas.init(cfg, torch.Generator().manual_seed(0), CPU)
    CheckpointManager(str(tmp_path)).save_weights(1, model)
    started = queue.Queue()
    t = threading.Thread(target=serve_cli.main, args=(
        ["--device", "cpu,cpu", "--save_dir", str(tmp_path), "--port", "0",
         "--max_batch", "2", "--max_wait_ms", "5", "--warmup", "1"]
        + SERVE_FLAGS, started.put), daemon=True)
    t.start()
    httpd = started.get(timeout=180)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    sigs = _signals(seed=8, n=4)
    texts = [None] * 4

    def post(i):
        body = json.dumps({"signal": sigs[i].tolist()}).encode()
        req = urllib.request.Request(
            url + "/transcribe", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            texts[i] = json.loads(r.read())["text"]

    try:
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            health = json.loads(r.read())
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        httpd.shutdown()
        t.join(timeout=60)
    assert not t.is_alive()
    assert health["devices"] == ["cpu", "cpu"]
    assert [r["devices"] for r in health["replicas"]] == [["cpu"], ["cpu"]]
    assert all(r["pid"] for r in health["replicas"])
    _gone([r["pid"] for r in health["replicas"]])
    one = Recognizer(model, cfg, CharEncoder(), "cpu")
    for s, text in zip(sigs, texts):
        b = 1 if len(s) <= SR else 2
        assert text == one.transcribe_signals([s, s], pad_seconds=b)[0]

    wavs = _wavs(str(tmp_path), np.random.default_rng(4))
    lines = {}
    for device in ("cpu", "cpu,cpu"):
        lines[device] = transcribe_cli.main(
            wavs + ["--device", device] + MODEL_FLAGS + [
                "--save_dir", assets + "/model", "--beam_size", "3",
                "--beam_logprob", "True", "--apply_lm", "True",
                "--lm_dir", assets + "/lm", "--ctc_beam_weight", "0.5"])
    assert lines["cpu,cpu"] == lines["cpu"] and len(lines["cpu"]) == 2
