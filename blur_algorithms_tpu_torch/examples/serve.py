"""HTTP blur service over BlurPipeline — the port's serving front end.

The port of the JAX package's ``examples/serve.py``: a threaded stdlib HTTP
server in front of shape-bucketed pipelines (``models/pipeline.py``) on
the card, with optional start-up warmup so no live request pays for a
cold bucket (the kernel library's build or load, a new shape's planning).

    python -m blur_algorithms_tpu_torch.examples.serve [--port 8700]
        [--sigma 10] [--engine auto] [--warmup 1080p 4k] [--device cuda]

API:
    POST /blur?sigma=10&engine=auto&kernel=gaussian&format=ppm   body: image bytes
        -> blurred image bytes (same container format as the request)
    GET  /healthz -> {"status": "ok", "backend": ..., "device": ..., "pipelines": {...}}

One ``BlurPipeline`` is cached per (sigma, engine, kernel). Two locks: the
short cache lock (the pipeline dict and counters; what ``/healthz``
takes) and the device lock, which covers a request's launches. A cold
bucket is prepared by ``ensure_compiled`` before the device lock is taken,
so it never blocks other requests or ``/healthz``; the result's
device-to-host copy (which waits for the launches) runs after the device
lock, before the encode. PPM and NPY bodies need no image library.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import torch

from blur_algorithms_tpu_torch.models.pipeline import BlurPipeline
from blur_algorithms_tpu_torch.utils.hw import entry_device
from blur_algorithms_tpu_torch.utils.io import decode_image, encode_image

_WARMUP_NAMES = {"720p": (720, 1280), "1080p": (1080, 1920),
                 "1440p": (1440, 2560), "4k": (2160, 3840)}


class BlurService:
    """Pipeline cache and device lock shared by all request threads."""

    def __init__(self, max_pipelines: int = 32, device: torch.device | str = "cuda"):
        self.device = entry_device(device)
        self._pipelines: dict[tuple, BlurPipeline] = {}
        self._cache_lock = threading.Lock()
        self._device_lock = threading.Lock()
        self._max = int(max_pipelines)
        self.requests = 0

    def pipeline(self, sigma: float, engine: str, kernel: str) -> BlurPipeline:
        key = (round(float(sigma), 4), engine, kernel)
        with self._cache_lock:
            pipe = self._pipelines.get(key)
            if pipe is None:
                if len(self._pipelines) >= self._max:
                    raise ValueError(
                        f"pipeline cache full ({self._max}); vary sigma less "
                        "or raise --max-pipelines"
                    )
                pipe = BlurPipeline(sigma, engine=engine, kernel=kernel, device=self.device)
                self._pipelines[key] = pipe
            return pipe

    def blur(self, body: bytes, fmt: str, sigma: float, engine: str,
             kernel: str) -> bytes:
        img = decode_image(body, fmt)
        pipe = self.pipeline(sigma, engine, kernel)
        # a cold bucket is prepared here, outside the device lock
        pipe.ensure_compiled(
            img.shape[-3], img.shape[-2], channels=img.shape[-1],
            batch=img.shape[:-3],
        )
        with self._device_lock:  # the request's launches
            out = pipe(img)
        host = out.cpu().numpy()  # waits for the launches
        with self._cache_lock:
            self.requests += 1
        return encode_image(host, fmt)

    def stats(self) -> dict:
        name = (torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
                else "cpu")
        with self._cache_lock:
            return {
                "status": "ok",
                "backend": self.device.type,
                "device": name,
                "requests": self.requests,
                "pipelines": {
                    f"sigma={k[0]} engine={k[1]} kernel={k[2]}": p.stats
                    for k, p in self._pipelines.items()
                },
            }


def make_handler(service: BlurService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, msg: str):
            self._send(code, json.dumps({"error": msg}).encode(), "application/json")

        def do_GET(self):
            if urlparse(self.path).path != "/healthz":
                return self._error(404, "unknown path (try /healthz)")
            self._send(200, json.dumps(service.stats()).encode(), "application/json")

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/blur":
                return self._error(404, "unknown path (try POST /blur)")
            q = parse_qs(url.query)

            def one(name, default):
                return q.get(name, [default])[-1]

            try:
                sigma = float(one("sigma", "10"))
                engine = one("engine", "auto")
                kernel = one("kernel", "gaussian")
                fmt = one("format", "png").lstrip(".").lower()
                n = int(self.headers.get("Content-Length", 0))
                if n <= 0:
                    return self._error(400, "empty body (send image bytes)")
                body = self.rfile.read(n)
                out = service.blur(body, fmt, sigma, engine, kernel)
            except ValueError as e:
                return self._error(400, str(e))
            except Exception as e:  # noqa: BLE001 — report, keep serving
                return self._error(500, f"{type(e).__name__}: {e}")
            self._send(200, out, f"image/{fmt}")

    return Handler


def serve(port: int = 8700, warmup=(), sigma: float = 10.0,
          engine: str = "auto", kernel: str = "gaussian",
          started: threading.Event | None = None,
          device: torch.device | str = "cuda"):
    """Start the service on 127.0.0.1:``port`` (0 picks a free port) and
    return the server; the caller runs ``serve_forever``. With no card it
    raises unless ``device="cpu"``."""
    from blur_algorithms_tpu_torch.utils.cache import enable_persistent_cache

    service = BlurService(device=device)
    # the kernel library from build/ (built once if absent), before any request
    enable_persistent_cache(service.device)
    if warmup:
        pipe = service.pipeline(sigma, engine, kernel)
        shapes = [_WARMUP_NAMES.get(str(s).lower(), None)
                  or tuple(int(v) for v in str(s).split("x")) for s in warmup]
        print(f"warming up {shapes} ...", flush=True)
        pipe.warmup(shapes)
    httpd = ThreadingHTTPServer(("127.0.0.1", port), make_handler(service))
    httpd.service = service  # for tests
    if started is not None:
        started.set()
    print(f"serving on http://127.0.0.1:{httpd.server_address[1]} "
          f"(POST /blur?sigma=S&engine=E, GET /healthz) on {service.device}", flush=True)
    return httpd


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--port", type=int, default=8700)
    p.add_argument("--sigma", type=float, default=10.0,
                   help="sigma to warm up (requests may use any sigma)")
    p.add_argument("--engine", default="auto")
    p.add_argument("--kernel", default="gaussian")
    p.add_argument("--warmup", nargs="*", default=(),
                   help="shapes to prepare: 720p/1080p/1440p/4k or HxW")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises with no card) or cpu")
    args = p.parse_args(argv)
    httpd = serve(args.port, args.warmup, args.sigma, args.engine, args.kernel,
                  device=args.device)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
