"""HTTP pose service over PoseEngines (counterpart of gdm_tpu/server.py).

The same wire protocol as the JAX package's service, so a client of one
talks to the other unchanged (npz over HTTP):

  POST /pose[?obj=NAME]   body: ``np.savez`` of the raw loader arrays
                          (keys/shapes/dtypes in ``GET /meta`` ->
                          ``raw_spec``; batch may be <= the engine batch,
                          short batches are padded server-side).
                          response: npz with ``poses`` [b, 3, 4]
                          (world->cam R|t, metres) and ``compute_ms``.
  GET  /healthz           {"ok": true, "objects": [...], ...}
  GET  /meta[?obj=NAME]   the engine's meta.

Objects are routed by the ``obj`` query parameter; with a single loaded
engine it may be omitted.  Device calls are serialised under one lock;
concurrent HTTP readers overlap only their host-side decode/encode.
Python-stdlib only (http.server + numpy).
"""

from __future__ import annotations

import io
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

import numpy as np

log = logging.getLogger("gdm_tpu_torch.server")


class RequestError(ValueError):
    """Client error -> HTTP status `code`."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class PoseService:
    """Routes requests to loaded engines; pads short batches.

    Args:
      engines: obj_name -> gdm_tpu_torch.serve.PoseEngine (or any object
        with ``meta["raw_spec"]`` and ``run(raw) -> numpy poses``).
    """

    def __init__(self, engines: dict):
        if not engines:
            raise ValueError("no engines")
        self.engines = dict(engines)
        self._lock = threading.Lock()
        # request-body cap: a full-batch uncompressed npz of the largest
        # engine, x4 headroom (npz framing, client padding); bounds the
        # allocation a hostile Content-Length can force
        self.max_body_bytes = 4 * max(
            sum(int(np.prod(shape)) * np.dtype(dtype).itemsize
                for shape, dtype in e.meta["raw_spec"].values())
            for e in self.engines.values())

    def resolve(self, obj: str | None):
        if obj is None:
            if len(self.engines) == 1:
                return next(iter(self.engines.values()))
            raise RequestError(
                400, f"multiple objects loaded, pass ?obj= one of "
                     f"{sorted(self.engines)}")
        try:
            return self.engines[obj]
        except KeyError:
            raise RequestError(
                404, f"unknown object {obj!r}; have {sorted(self.engines)}")

    def run(self, obj: str | None, raw: dict):
        """Validate against the engine's raw_spec, pad the batch to the
        engine batch (repeating the last sample: every padded row is a
        valid frame, where zero fill would NaN the backprojection), run,
        and slice the poses back to the request batch."""
        eng = self.resolve(obj)
        spec = eng.meta["raw_spec"]
        missing = sorted(set(spec) - set(raw))
        extra = sorted(set(raw) - set(spec))
        if missing or extra:
            raise RequestError(
                400, f"raw arrays mismatch: missing {missing}, "
                     f"unexpected {extra} (see GET /meta raw_spec)")
        cap = int(spec[next(iter(spec))][0][0])
        b = None
        fed = {}
        for k in sorted(spec):
            shape, dtype = spec[k]
            a = np.asarray(raw[k])
            if str(a.dtype) != dtype:
                raise RequestError(
                    400, f"{k}: dtype {a.dtype}, engine wants {dtype}")
            if a.ndim != len(shape) or list(a.shape[1:]) != shape[1:]:
                raise RequestError(
                    400, f"{k}: shape {list(a.shape)}, engine wants "
                         f"[<= {shape[0]}, {', '.join(map(str, shape[1:]))}]")
            if b is None:
                b = a.shape[0]
            elif a.shape[0] != b:
                raise RequestError(400, f"{k}: batch {a.shape[0]} != {b}")
            fed[k] = a
        if b == 0 or b > cap:
            raise RequestError(
                400, f"batch {b} outside [1, {cap}] (engine batch {cap};"
                     " split larger requests client-side)")
        if b < cap:
            fed = {k: np.concatenate(
                [a, np.repeat(a[-1:], cap - b, axis=0)]) for k, a in
                fed.items()}
        with self._lock:
            t0 = time.perf_counter()
            poses = np.asarray(eng.run(fed))
            ms = (time.perf_counter() - t0) * 1e3
        return poses[:b], ms

    def warmup(self):
        """One synthetic full batch per engine, so the first request does
        not pay the device's first-call set-up."""
        for name, eng in sorted(self.engines.items()):
            self.run(name, synthetic_raw(eng.meta["raw_spec"]))


def synthetic_raw(spec: dict) -> dict:
    """A valid zero-information batch for a ``raw_spec`` ({key: [shape,
    dtype]}): zeros, with 0.5 m depth and non-degenerate intrinsics (the
    backprojection divides by fx, fy).  The same fill as
    gdm_tpu.serve.synthetic_raw."""
    raw = {k: np.zeros(tuple(shape), np.dtype(dtype))
           for k, (shape, dtype) in spec.items()}
    if "dpt_filled" in raw:
        raw["dpt_filled"] += np.float32(0.5)
    if "dpt_u16" in raw:                # 5000 counts / 10000 = 0.5 m
        raw["dpt_u16"] += np.uint16(5000)
        raw["dpt_scale"] += np.float32(10000.0)
    if "K_crop" in raw:
        im = raw["rgb_u8"].shape[1] if "rgb_u8" in raw else 256
        raw["K_crop"] += np.asarray(
            [[500.0, 0, im / 2], [0, 500.0, im / 2], [0, 0, 1]],
            raw["K_crop"].dtype)
    return raw


def encode_arrays(arrays: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def decode_arrays(body: bytes) -> dict:
    with np.load(io.BytesIO(body), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


class _Handler(BaseHTTPRequestHandler):
    # set by make_server
    service: PoseService = None
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route through logging, not stderr
        log.info("%s " + fmt, self.client_address[0], *args)

    def _reply(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        if self.close_connection:   # early exits that left a body unread
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, obj):
        self._reply(code, json.dumps(obj).encode(), "application/json")

    def _obj(self):
        q = parse_qs(urlsplit(self.path).query)
        return q["obj"][0] if "obj" in q else None

    def do_GET(self):
        path = urlsplit(self.path).path
        try:
            if path == "/healthz":
                engines = self.service.engines
                self._reply_json(200, {
                    "ok": True,
                    "objects": sorted(engines),
                    "platforms": {n: list(e.platforms)
                                  for n, e in engines.items()},
                })
            elif path == "/meta":
                self._reply_json(200, self.service.resolve(self._obj()).meta)
            else:
                self._reply_json(404, {"error": f"no route {path}"})
        except RequestError as e:
            self._reply_json(e.code, {"error": str(e)})

    def do_POST(self):
        # early-exit replies that leave the body unread must close the
        # connection: under HTTP/1.1 keep-alive the unread npz bytes
        # would otherwise be parsed as the next request line
        path = urlsplit(self.path).path
        try:
            n = int(self.headers.get("Content-Length", 0))
        except ValueError:
            self.close_connection = True
            self._reply_json(400, {"error": "bad Content-Length"})
            return
        if path != "/pose":
            self.close_connection = True
            self._reply_json(404, {"error": f"no route {path}"})
            return
        if n <= 0 or n > self.service.max_body_bytes:
            self.close_connection = True
            self._reply_json(413 if n > 0 else 400, {
                "error": f"body size {n} outside (0, "
                         f"{self.service.max_body_bytes}] (4x the "
                         "largest engine's full-batch npz)"})
            return
        try:
            try:
                raw = decode_arrays(self.rfile.read(n))
            except Exception as e:
                raise RequestError(400, f"body is not an npz: {e}")
            poses, ms = self.service.run(self._obj(), raw)
            self._reply(200, encode_arrays(
                {"poses": poses, "compute_ms": np.float32(ms)}),
                "application/octet-stream")
        except RequestError as e:
            self._reply_json(e.code, {"error": str(e)})
        except Exception as e:   # never kill the daemon on one request
            self._reply_json(500, {"error": f"{type(e).__name__}: {e}"})


def make_server(service: PoseService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Bound, ready-to-serve ThreadingHTTPServer (port 0 = ephemeral;
    read ``server.server_address`` for the bound port).  The caller runs
    ``serve_forever()`` (blocking) or on a thread; ``shutdown()`` stops."""
    handler = type("Handler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)


def request_poses(url: str, raw: dict, obj: str | None = None,
                  timeout: float = 120.0):
    """Client helper: POST raw arrays, return (poses [b,3,4], compute_ms).

    ``url`` is the server base, e.g. ``http://127.0.0.1:8360``.  Raises
    RuntimeError with the server's error message on a non-200 reply."""
    from urllib.error import HTTPError
    from urllib.parse import quote
    from urllib.request import Request, urlopen

    target = url.rstrip("/") + "/pose" + (
        f"?obj={quote(obj, safe='')}" if obj else "")
    req = Request(target, data=encode_arrays(raw),
                  headers={"Content-Type": "application/octet-stream"})
    try:
        with urlopen(req, timeout=timeout) as resp:
            out = decode_arrays(resp.read())
    except HTTPError as e:
        try:
            msg = json.loads(e.read().decode()).get("error", str(e))
        except Exception:
            msg = str(e)
        raise RuntimeError(f"pose request failed ({e.code}): {msg}")
    return out["poses"], float(out["compute_ms"])
