"""HTTP serving front-end: dynamic-batching ASR over a trained checkpoint
(counterpart of the repository's serve.py, on the same flags).

    python -m automatic_speech_recognition_torch.serve --save_dir <model> \\
        --unit char --port 8000 [--device cuda]
    curl -s -X POST --data-binary @utt.flac localhost:8000/transcribe

Endpoints (stdlib http.server):
  POST /transcribe   body = WAV or FLAC bytes -> {"text": ...}
                     or JSON {"signal": [...floats], "sample_rate": N}
  GET  /healthz      liveness and the torch devices
  GET  /stats        batching and latency counters (ServingStats.snapshot)

Concurrent requests are coalesced by serving.BatchingRecognizer into
length-bucketed batches of --max_batch, one featurize + decode each (the
fused CUDA kernel on a GPU), split over every device --device names
(api.Recognizer: a comma list is a data axis, 'cuda' one GPU); --warmup
1 runs every bucket once before the port opens.  A bad payload answers
400, a failure of the decode path 503.
The server thread pool and the batcher stop together when serve_forever
returns (KeyboardInterrupt, or httpd.shutdown() from another thread).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import tempfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from automatic_speech_recognition_torch.config import Config, build_parser
from automatic_speech_recognition_torch.data.audio_io import read_audio

from .api import Recognizer
from .serving import BatchingRecognizer
from .parallel.mesh import devices_for
from .utils.device import disable_tf32, split_device

log = logging.getLogger("serve")

SERVE_FLAGS = ("host", "port", "max_batch", "max_wait_ms", "warmup")


def parse(argv: Optional[Sequence[str]] = None) -> Tuple[Config, Dict]:
    """(config, serving options): config.py's flags and serve.py's own."""
    p = build_parser()
    g = p.add_argument_group("serving")
    g.add_argument("--host", type=str, default="127.0.0.1")
    g.add_argument("--port", type=int, default=8000)
    g.add_argument("--max_batch", type=int, default=8,
                   help="signals per device batch")
    g.add_argument("--max_wait_ms", type=float, default=20.0,
                   help="max time a request waits for batch co-riders")
    g.add_argument("--warmup", type=int, default=1,
                   help="run every bucket once before accepting traffic "
                        "(1) or not (0)")
    ns = vars(p.parse_args(argv))
    serve_opts = {k: ns.pop(k) for k in SERVE_FLAGS}
    return Config(**ns), serve_opts


def decode_body(body: bytes, content_type: str, expect_sr: int) -> np.ndarray:
    """Request body -> float32 waveform at the model's sample rate."""
    if content_type.startswith("application/json"):
        obj = json.loads(body)
        sr = int(obj.get("sample_rate", expect_sr))
        if sr != expect_sr:
            raise ValueError(f"sample rate {sr} != model's {expect_sr}")
        return np.asarray(obj["signal"], np.float32)
    # audio container: sniff WAV/FLAC with the reader the pipeline uses
    suffix = ".wav" if body[:4] == b"RIFF" else ".flac"
    with tempfile.NamedTemporaryFile(suffix=suffix, delete=False) as f:
        f.write(body)
        path = f.name
    try:
        sig, sr = read_audio(path)
    finally:
        os.unlink(path)
    if sr != expect_sr:
        raise ValueError(f"sample rate {sr} != model's {expect_sr}")
    return np.asarray(sig, np.float32)


def make_handler(server: BatchingRecognizer, sample_rate: int):
    """The request handler class over `server`."""
    device = server.rec.device
    health = {"status": "ok",
              "devices": [str(d) for d in server.rec.mesh.devices],
              "device_name": (torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu")}

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _reply(self, code: int, obj) -> None:
            payload = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):  # noqa: N802 (stdlib naming)
            if self.path == "/healthz":
                self._reply(200, health)
            elif self.path == "/stats":
                self._reply(200, server.stats.snapshot())
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/transcribe":
                self._reply(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                sig = decode_body(self.rfile.read(n),
                                  self.headers.get("Content-Type", ""),
                                  sample_rate)
            except Exception as e:
                # a bad payload (malformed JSON or audio, wrong rate): the
                # client's fault
                self._reply(400, {"error": str(e)})
                return
            try:
                self._reply(200, {"text": server.transcribe(sig)})
            except ValueError as e:
                # submit()'s oversize-signal rejection: the client's fault
                self._reply(400, {"error": str(e)})
            except Exception as e:
                # a failure of the decode path: the server's fault, 503 so
                # a balancer retries elsewhere
                log.exception("transcription failed")
                self._reply(503, {"error": str(e)})

        def log_message(self, fmt, *args):
            log.info("%s - %s", self.address_string(), fmt % args)

    return Handler


def main(argv: Optional[Sequence[str]] = None,
         ready: Optional[Callable[[ThreadingHTTPServer], None]] = None
         ) -> None:
    """Serve until interrupted or until another thread calls shutdown()
    on the server, which `ready` receives once the port is open (with
    --port 0, server_address holds the port the system chose)."""
    device_name, argv = split_device(argv)
    cfg, opts = parse(argv)
    logging.basicConfig(force=True, stream=sys.stdout, level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(message)s")
    if devices_for(device_name)[0].type == "cuda":
        disable_tf32()
    rec = Recognizer.from_checkpoint(
        cfg.save_dir, cfg, epoch=cfg.restore_epoch,
        lm_dir=cfg.lm_dir if cfg.apply_lm else "", device=device_name)
    batcher = BatchingRecognizer(
        rec, max_batch=opts["max_batch"], max_wait_ms=opts["max_wait_ms"],
        beam_size=cfg.beam_size if cfg.beam_size > 1 else 0)
    if opts["warmup"]:
        log.info("warming %d buckets (batch %d)...",
                 len(batcher.bucket_seconds), batcher.max_batch)
        batcher.warmup()
        log.info("warmup done")
    batcher.start()
    try:
        httpd = ThreadingHTTPServer((opts["host"], opts["port"]),
                                    make_handler(batcher, cfg.sample_rate))
        try:
            log.info("serving on %s:%d on %s (buckets %s s, max_batch %d, "
                     "wait %.0f ms)", *httpd.server_address[:2],
                     ", ".join(map(str, rec.mesh.devices)),
                     batcher.bucket_seconds, batcher.max_batch,
                     opts["max_wait_ms"])
            if ready is not None:
                ready(httpd)
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.server_close()
    finally:
        batcher.stop()


if __name__ == "__main__":
    main()
