"""Zero-dependency HTTP front end for the ServingEngine.

Endpoints (ThreadingHTTPServer — concurrent requests coalesce in the
engine's micro-batcher):

- ``GET  /healthz``                     -> engine + device status JSON
- ``POST /embed_text``   JSON ``{"texts": [...]}``
                                        -> ``{"embeddings": [[...]]}``
- ``POST /embed_video``  body = one ``.npy`` uint8 (B, T, H, W, C) at
  the deployment clip shape; ``?boxes=1`` adds predicted hand/object
  boxes          -> ``{"embeddings": [[...]], "boxes": [[...]]?}``
- ``POST /similarity``   body = one ``.npz`` with ``video`` (as above)
  and ``texts`` (array of strings)
                 -> ``{"sim": [[...]]}`` cosine text x video

Video rides as ``.npy``/``.npz`` bytes (dense uint8 — JSON would 4x the
payload); everything else is JSON. Counterpart of
``helping_hand_for_egocentric_videos_tpu/serve/server.py``.
"""

from __future__ import annotations

import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from .engine import ServingEngine

__all__ = ["make_server"]


def _cos(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    return a @ b.T


def make_server(engine: ServingEngine, host: str = "127.0.0.1", port: int = 8471):
    """-> a ThreadingHTTPServer bound to (host, port); caller runs
    ``serve_forever()`` (and ``shutdown()`` to stop)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet access log; /healthz has stats
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n)

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                self._json(200, engine.health())
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            url = urlparse(self.path)
            try:
                if url.path == "/embed_text":
                    texts = json.loads(self._body())["texts"]
                    if isinstance(texts, str) or not all(
                        isinstance(t, str) for t in texts
                    ):
                        # a bare string would iterate character-by-character
                        # into len(s) nonsense embeddings — reject, not 200
                        raise ValueError("'texts' must be a list of strings")
                    emb = engine.submit_text(texts)
                    self._json(200, {"embeddings": emb.tolist()})
                elif url.path == "/embed_video":
                    video = np.load(io.BytesIO(self._body()), allow_pickle=False)
                    emb, boxes = engine.submit_video(video)
                    out = {"embeddings": emb.tolist()}
                    if parse_qs(url.query).get("boxes", ["0"])[0] == "1":
                        out["boxes"] = boxes.tolist()
                    self._json(200, out)
                elif url.path == "/similarity":
                    npz = np.load(io.BytesIO(self._body()), allow_pickle=False)
                    texts = [str(t) for t in npz["texts"]]
                    emb_v, _ = engine.submit_video(npz["video"])
                    emb_t = engine.submit_text(texts)
                    self._json(200, {"sim": _cos(emb_t, emb_v).tolist()})
                else:
                    self._json(404, {"error": f"no route {url.path}"})
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                self._json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — engine/device failures:
                # clients must see a structured 500, not a dropped socket
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)
