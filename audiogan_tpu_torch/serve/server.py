"""Minimal HTTP inference server over an exported sampler.

Endpoints (as audiogan_tpu/serve/server.py):
  GET  /healthz   -> {"status": "ok", "model": ..., "num": ..., ...}
  POST /generate  -> body {"seed": int, "num"?: int <= artifact num,
                           "labels"?: [int] (conditional models)}
     response: {"sample_rate": int, "num": int, "wavs": [base64 wav...]}

A request for fewer clips than the artifact's batch runs the full batch and
returns a prefix. One lock serialises generation: one batch on the card at
a time. Malformed requests get 400 with an error message.
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from audiogan_tpu_torch.data.wavio import wav_bytes
from audiogan_tpu_torch.serve.export import ServedSampler


def make_server(sampler: ServedSampler, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Build (not start) the server; .server_address has the bound port."""
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._json(404, {"error": "not found"})
            self._json(200, {"status": "ok",
                             "model": sampler.meta.get("model"),
                             "num": sampler.num,
                             "sample_rate": sampler.sample_rate,
                             "clip_len": sampler.meta["clip_len"],
                             "conditional": sampler.conditional})

        def do_POST(self):
            if self.path != "/generate":
                return self._json(404, {"error": "not found"})
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("the body must be a JSON object")
                seed = int(req.get("seed", 0))
                num = int(req.get("num", sampler.num))
                if not 1 <= num <= sampler.num:
                    raise ValueError(
                        f"num must be in [1, {sampler.num}] "
                        f"(the artifact's batch)")
                labels = req.get("labels")
                if labels is not None:
                    labels = np.asarray(labels)
                    if labels.ndim != 1 or labels.shape[0] != num:
                        raise ValueError("labels must be a list of num ints")
                    # pad to the artifact batch; the prefix is returned
                    full = np.zeros((sampler.num,), labels.dtype)
                    full[:num] = labels
                    labels = full
                with lock:  # one batch on the card at a time
                    waves = sampler.generate(seed, labels)[:num]
            except (ValueError, TypeError, KeyError,
                    json.JSONDecodeError) as e:
                return self._json(400, {"error": str(e)})
            wavs = [base64.b64encode(
                wav_bytes(sampler.sample_rate, w)).decode()
                for w in waves]
            self._json(200, {"sample_rate": sampler.sample_rate,
                             "num": num, "wavs": wavs})

    return ThreadingHTTPServer((host, port), Handler)
