"""The port's HTTP server, automatic_speech_recognition_torch/serve.py, on
the CPU over a real localhost socket: the round trip of
tests/test_serving.py::test_http_server_round_trip through serve.main
(port 0, the server in a thread, shut down in every case)."""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import json
import queue
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from automatic_speech_recognition_torch import serve as serve_cli
from automatic_speech_recognition_torch.api import Recognizer
from automatic_speech_recognition_torch.data.audio_io import (read_audio,
                                                              write_wav)
from automatic_speech_recognition_torch.models import las
from automatic_speech_recognition_torch.training.checkpoint import (
    CheckpointManager)
from automatic_speech_recognition_torch.utils.tokenizer import CharEncoder

from flac_encoder import encode_flac
from test_torch_las import small_cfg

SR = 16000
FLAGS = ["--unit", "char", "--feat_dim", "13", "--enc_units", "32",
         "--num_enc_channels", "4", "--num_enc_layers", "2",
         "--dec_units", "32", "--num_dec_layers", "2", "--embedding_size",
         "16", "--attention_size", "16", "--mode", "loc",
         "--convert_rate", "0.12", "--max_audio_seconds", "4",
         "--beam_size", "1"]


@pytest.fixture
def server(tmp_path):
    """serve.main on port 0 in a thread; yields (base URL, recognizer of
    the same checkpoint); shuts the server and its batcher down."""
    cfg = small_cfg(max_audio_seconds=4)
    model = las.init(cfg, torch.Generator().manual_seed(0), "cpu")
    CheckpointManager(str(tmp_path)).save_weights(1, model)
    started = queue.Queue()
    t = threading.Thread(target=serve_cli.main, args=(
        ["--device", "cpu", "--save_dir", str(tmp_path), "--port", "0",
         "--max_batch", "2", "--max_wait_ms", "5", "--warmup", "0"] + FLAGS,
        started.put), daemon=True)
    t.start()
    httpd = started.get(timeout=120)
    try:
        yield (f"http://127.0.0.1:{httpd.server_address[1]}",
               Recognizer(model, cfg, CharEncoder(), "cpu"))
    finally:
        httpd.shutdown()
        t.join(timeout=60)
    assert not t.is_alive()


def _post(url, body, content_type):
    req = urllib.request.Request(url + "/transcribe", data=body,
                                 headers={"Content-Type": content_type})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_http_round_trip(server, tmp_path):
    url, rec = server
    with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and health["devices"] == ["cpu"]

    sig = (np.random.default_rng(1).standard_normal(SR // 2)
           .astype(np.float32) * 0.1)
    want = rec.transcribe_signals([sig, sig], pad_seconds=1)[0]
    got = _post(url, json.dumps({"signal": sig.tolist(),
                                 "sample_rate": SR}).encode(),
                "application/json")["text"]
    assert got == want
    # WAV bytes: the 16-bit file's samples through the same recognizer
    write_wav(str(tmp_path / "u.wav"), sig, SR)
    body = (tmp_path / "u.wav").read_bytes()
    wav_sig, _ = read_audio(str(tmp_path / "u.wav"))
    assert _post(url, body, "audio/wav")["text"] == \
        rec.transcribe_signals([wav_sig, wav_sig], pad_seconds=1)[0]
    # FLAC bytes of the same 16-bit samples give the same text
    pcm = np.round(np.clip(sig, -1, 1) * 32767).astype(np.int32)
    assert _post(url, encode_flac([pcm]), "audio/flac")["text"] == \
        rec.transcribe_signals([wav_sig, wav_sig], pad_seconds=1)[0]

    # a wrong sample rate and an oversize signal are the client's fault
    for bad in ({"signal": [0.0] * 100, "sample_rate": 8000},
                {"signal": [0.0] * (5 * SR), "sample_rate": SR}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, json.dumps(bad).encode(), "application/json")
        assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url + "/nothing", timeout=10)
    assert e.value.code == 404

    with urllib.request.urlopen(url + "/stats", timeout=10) as r:
        snap = json.loads(r.read())
    assert snap["requests"] == 3 and snap["errors"] == 0


def test_concurrent_requests_batch_together(server):
    url, rec = server
    rng = np.random.default_rng(2)
    sigs = [(rng.standard_normal(int(SR * s)) * 0.1).astype(np.float32)
            for s in (0.4, 0.7, 0.9, 0.5)]
    texts = [None] * len(sigs)

    def client(i):
        texts[i] = _post(url, json.dumps({"signal": sigs[i].tolist()})
                         .encode(), "application/json")["text"]

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(sigs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    # each text equals the recognizer's on a batch padded like the server's
    for s, text in zip(sigs, texts):
        assert text == rec.transcribe_signals([s, s], pad_seconds=1)[0]
    with urllib.request.urlopen(url + "/stats", timeout=10) as r:
        snap = json.loads(r.read())
    assert snap["requests"] == 4 and snap["batches"] <= 4
    # the span totals of this process (utils/spans.py): the served batches
    # and the layers they ran
    assert snap["spans"]["serve.batch"]["calls"] >= snap["batches"]
    assert {"recognizer.featurize", "las.listener",
            "las.speller"} <= set(snap["spans"])


def test_a_missing_gpu_is_refused(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.main(["--save_dir", str(tmp_path)] + FLAGS)
