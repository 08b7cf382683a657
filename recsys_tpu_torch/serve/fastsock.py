"""Raw-socket serving front end (counterpart of
``recsys_tpu/serve/fastsock.py``): a persistent TCP connection carrying
length-prefixed request and answer bodies in the formats
`server.parse_request` takes (JSON, NPZ1, RAW1). It spares a
latency-critical caller the HTTP or gRPC framing of every call.

Wire format, both directions::

    [u32 big-endian body length][body bytes]

A zero-length frame from the client closes the connection. An error comes
back as a JSON body ``{"error": ...}`` (the client raises). A frame longer
than `MAX_FRAME_BYTES` is refused before anything is allocated for it:
the server answers with an error body and closes the connection.
"""

from __future__ import annotations

import json
import socket
import struct
import threading

import numpy as np

from recsys_tpu_torch.serve.client import _parse_response, prepare_body
from recsys_tpu_torch.serve.export import Servable
from recsys_tpu_torch.serve.server import (_error, _MicroBatcher,
                                           encode_response, parse_request)

_LEN = struct.Struct(">I")

#: the largest body a frame may announce: a 4-byte header alone would
#: otherwise ask for a buffer of up to 4 GiB
MAX_FRAME_BYTES = 64 * 1024 * 1024


def _recv_exact(conn: socket.socket, n: int) -> bytes | None:
    """``n`` bytes from ``conn``, or None when the peer closes first."""
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def _send(conn: socket.socket, body: bytes) -> None:
    conn.sendall(_LEN.pack(len(body)) + body)


def _handle(conn: socket.socket, batcher: _MicroBatcher) -> None:
    """Answer one connection's frames until it closes."""
    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    with conn:
        while True:
            head = _recv_exact(conn, _LEN.size)
            if head is None:
                return
            (length,) = _LEN.unpack(head)
            if length == 0:
                return
            if length > MAX_FRAME_BYTES:
                _send(conn, json.dumps({
                    "error": f"frame length {length} exceeds max "
                             f"{MAX_FRAME_BYTES}"}).encode())
                return
            body = _recv_exact(conn, length)
            if body is None:
                return
            try:
                feats, fmt = parse_request(body)
                out = encode_response(batcher.predict(feats), fmt)
            except Exception as e:  # boundary: an error frame, keep serving
                out = _error(e)
            _send(conn, out)


class SocketServer:
    """An accept loop on 127.0.0.1:``port`` (0: a free port, then
    ``.port``) and one handler thread per connection, predicting through
    ``batcher`` (or a new micro-batcher). ``start`` serves; ``shutdown``
    closes the listening socket and ends the accept loop."""

    def __init__(self, servable: Servable, port: int,
                 batcher: _MicroBatcher | None = None):
        self.batcher = batcher or _MicroBatcher(servable)
        self.sock = socket.create_server(("127.0.0.1", port))
        self.port = self.sock.getsockname()[1]
        self.thread = threading.Thread(target=self._accept_loop, daemon=True)

    def start(self) -> None:
        self.thread.start()

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:            # the listening socket was closed
                return
            threading.Thread(target=_handle, args=(conn, self.batcher),
                             daemon=True).start()

    def shutdown(self, timeout: float = 5.0) -> None:
        # shutdown() wakes an accept() blocked in another thread
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()
        if self.thread.is_alive():
            self.thread.join(timeout)


class SocketClient:
    """One persistent connection. Bodies prepared ahead
    (`client.prepare_body`) let a latency measurement time the round trip
    alone."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self.conn = socket.create_connection((host, port))
        self.conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def send(self, body: bytes) -> np.ndarray:
        """One prepared body → predictions (raises on an error body)."""
        _send(self.conn, body)
        head = _recv_exact(self.conn, _LEN.size)
        if head is None:
            raise ConnectionError("the server closed the connection")
        (length,) = _LEN.unpack(head)
        raw = _recv_exact(self.conn, length)
        if raw is None:
            raise ConnectionError("truncated answer")
        return _parse_response(raw)

    def predict(self, features: dict[str, np.ndarray],
                fmt: str = "npz") -> np.ndarray:
        return self.send(prepare_body(features, fmt))

    def close(self) -> None:
        try:
            _send(self.conn, b"")
        except OSError:
            pass
        self.conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
