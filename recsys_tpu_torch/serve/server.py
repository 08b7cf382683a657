"""REST serving with micro-batching (counterpart of
``recsys_tpu/serve/server.py``).

- REST: ``POST /v1/models/<name>:predict`` with ``{"instances": [...]}`` →
  ``{"predictions": [...]}`` (TF-Serving's JSON surface), or a binary
  columnar body in the NPZ1 or RAW1 format, answered in the same format.
- A micro-batching queue coalesces concurrent requests into one device
  call.

Feature payloads: each instance is ``{"ids": [39 ints], "dense": [13
floats]}`` for the Criteo models and ``{"i_id": int, "i_cate": int,
"hist_iid": [P ints], "hist_cate": [P ints]}`` for DIN; the columnar
formats carry the same names as arrays. The micro-batcher concatenates the
requests it coalesces, so DIN requests with different P that land in one
device call fail together (as in the JAX package). gRPC and the raw-socket
front end are not ported yet.
"""

from __future__ import annotations

import io
import json
import queue
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from recsys_tpu_torch.serve.export import Servable


class _MicroBatcher:
    """Coalesce concurrent predict calls into single device invocations.

    Batching is opportunistic: a request never waits for company; whatever
    is already queued when the worker picks up a request rides the same
    device call, up to ``MAX_BATCH`` rows. Each request is checked
    (`Servable.check`) on its caller's thread before it is queued or run
    inline, so an invalid one raises to its own caller only."""

    MAX_BATCH = 4096

    def __init__(self, servable: Servable):
        self.servable = servable
        self.q: queue.Queue = queue.Queue()
        self._inline = threading.Lock()
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def predict(self, features: dict[str, np.ndarray]) -> np.ndarray:
        # Uncontended fast path: nothing queued and no inline call running →
        # predict on the caller's thread, without the queue handoff's two
        # thread wake-ups. Under load the lock is held or the queue is not
        # empty, so requests fall through to the coalescing worker.
        if self.q.empty() and self._inline.acquire(blocking=False):
            try:
                return self.servable.predict(features)   # checks them first
            finally:
                self._inline.release()
        # checked here, on the caller's thread, so that a bad request fails
        # alone and never reaches the group it would be coalesced with
        self.servable.check(features)
        ev = threading.Event()
        slot: dict = {"features": features, "event": ev}
        self.q.put(slot)
        ev.wait()
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["result"]

    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self.q.get(timeout=0.1)
            except queue.Empty:
                continue
            group = [first]
            n = len(next(iter(first["features"].values())))
            while n < self.MAX_BATCH:
                try:
                    nxt = self.q.get_nowait()
                except queue.Empty:
                    break
                group.append(nxt)
                n += len(next(iter(nxt["features"].values())))
            try:
                keys = first["features"].keys()
                merged = {
                    k: np.concatenate([g["features"][k] for g in group])
                    for k in keys
                }
                probs = self.servable.predict(merged)
                lo = 0
                for g in group:
                    cnt = len(next(iter(g["features"].values())))
                    g["result"] = probs[lo:lo + cnt]
                    lo += cnt
            except Exception as e:  # boundary: report to every caller
                for g in group:
                    g["error"] = f"{type(e).__name__}: {e}"
            finally:
                for g in group:
                    g["event"].set()

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        self.thread.join(timeout)


#: magic prefix of the binary columnar payload (np.savez of the feature
#: dict); JSON instance lists remain the default wire format.
BINARY_MAGIC = b"NPZ1"

#: zero-copy columnar payload: fixed little-endian header + raw array bytes.
#: Layout: b"RAW1" | u8 n_arrays | per array: [u8 name_len | name utf-8 |
#: u8 dtype_char ('i'=int32,'f'=float32) | u8 ndim | u32×ndim dims] |
#: concatenated C-order array buffers.
RAW_MAGIC = b"RAW1"

_RAW_DTYPES = {"i": np.dtype("<i4"), "f": np.dtype("<f4")}


def encode_raw(arrays: dict[str, np.ndarray]) -> bytes:
    head = [RAW_MAGIC, bytes([len(arrays)])]
    bufs = []
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        if arr.dtype.kind in "iu":
            arr, ch = arr.astype("<i4", copy=False), b"i"
        else:
            arr, ch = arr.astype("<f4", copy=False), b"f"
        nb = name.encode()
        head.append(bytes([len(nb)]) + nb + ch + bytes([arr.ndim])
                    + struct.pack(f"<{arr.ndim}I", *arr.shape))
        bufs.append(arr.tobytes())
    return b"".join(head) + b"".join(bufs)


def parse_raw(body: bytes) -> dict[str, np.ndarray]:
    n_arrays = body[4]
    pos = 5
    metas = []
    for _ in range(n_arrays):
        nlen = body[pos]
        pos += 1
        name = body[pos:pos + nlen].decode()
        pos += nlen
        ch = chr(body[pos])
        ndim = body[pos + 1]
        pos += 2
        shape = struct.unpack_from(f"<{ndim}I", body, pos)
        pos += 4 * ndim
        metas.append((name, _RAW_DTYPES[ch], shape))
    out = {}
    for name, dt, shape in metas:
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        out[name] = np.frombuffer(body, dt, count, pos).reshape(shape)
        pos += count * dt.itemsize
    return out


def parse_request(body: bytes) -> tuple[dict[str, np.ndarray], str]:
    """bytes → (features, fmt) with fmt in {'json', 'npz', 'raw'}."""
    if body[:4] == RAW_MAGIC:
        return parse_raw(body), "raw"
    if body[:4] == BINARY_MAGIC:
        with np.load(io.BytesIO(body[4:])) as z:
            return {k: z[k] for k in z.files}, "npz"
    return _instances_to_features(json.loads(body)["instances"]), "json"


def encode_response(probs: np.ndarray, fmt: str) -> bytes:
    """``fmt``: 'json' | 'npz' | 'raw'."""
    if fmt == "raw":
        return encode_raw({"predictions": np.asarray(probs, np.float32)})
    if fmt == "npz":
        buf = io.BytesIO()
        np.savez(buf, predictions=np.asarray(probs, np.float32))
        return BINARY_MAGIC + buf.getvalue()
    return json.dumps({"predictions": [float(p) for p in probs]}).encode()


def _instances_to_features(instances: list[dict]) -> dict[str, np.ndarray]:
    feats = {}
    for k in instances[0].keys():
        arr = np.asarray([inst[k] for inst in instances])
        if arr.dtype.kind in "iu":
            arr = arr.astype(np.int32)
        elif arr.dtype.kind == "f":
            arr = arr.astype(np.float32)
        feats[k] = arr
    return feats


def make_rest_server(servable: Servable, port: int):
    """(ThreadingHTTPServer on 127.0.0.1:port, its batcher); ``port=0``
    binds a free port (``server.server_address[1]``). The caller runs
    ``serve_forever`` and, at the end, ``shutdown``, ``server_close`` and
    ``batcher.stop``."""
    batcher = _MicroBatcher(servable)
    model_name = servable.model_name

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code: int, out: bytes):
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                feats, fmt = parse_request(self.rfile.read(length))
                out = encode_response(batcher.predict(feats), fmt)
                code = 200
            except Exception as e:  # boundary: answer 400, keep serving
                out = json.dumps({"error": f"{type(e).__name__}: {e}"}).encode()
                code = 400
            self._reply(code, out)

        def do_GET(self):
            # model status endpoint
            self._reply(200, json.dumps({
                "model_version_status": [{
                    "version": "1", "state": "AVAILABLE",
                    "model_name": model_name,
                }]
            }).encode())

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    return server, batcher
