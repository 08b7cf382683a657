"""Serving clients (counterpart of ``recsys_tpu/serve/client.py``): build
a request body, send it over REST or gRPC, parse the predictions; and
`benchmark_serving`, the reference client's latency and AUC check (a
warm-up, timed round trips, the AUC of the answers against held-out
labels). The raw-socket client is `fastsock.SocketClient`."""

from __future__ import annotations

import io
import json
import time
import urllib.request

import numpy as np

from recsys_tpu_torch.serve.server import (BINARY_MAGIC, GRPC_METHOD,
                                           RAW_MAGIC, encode_raw, parse_raw)


def features_to_instances(features: dict[str, np.ndarray]) -> list[dict]:
    keys = list(features.keys())
    n = len(features[keys[0]])
    return [
        {k: np.asarray(features[k][i]).tolist() for k in keys}
        for i in range(n)
    ]


def prepare_body(features: dict[str, np.ndarray], fmt: str = "json") -> bytes:
    """Serialize a request ahead of time, so that a latency measurement
    times only the round trip. ``fmt``: 'json' (TF-Serving instances),
    'npz' (NPZ1 columnar) or 'raw' (RAW1 zero-copy columnar)."""
    if fmt == "raw":
        return encode_raw(features)
    if fmt == "npz":
        buf = io.BytesIO()
        np.savez(buf, **{k: np.asarray(v) for k, v in features.items()})
        return BINARY_MAGIC + buf.getvalue()
    if fmt == "json":
        return json.dumps(
            {"instances": features_to_instances(features)}).encode()
    raise ValueError(f"unknown request format {fmt!r}")


def _parse_response(raw: bytes) -> np.ndarray:
    if raw[:4] == RAW_MAGIC:
        return parse_raw(raw)["predictions"]
    if raw[:4] == BINARY_MAGIC:
        with np.load(io.BytesIO(raw[4:])) as z:
            return z["predictions"].astype(np.float32)
    out = json.loads(raw)
    if "error" in out:
        raise RuntimeError(out["error"])
    return np.asarray(out["predictions"], np.float32)


def rest_send(port: int, body: bytes, model_name: str = "model") -> np.ndarray:
    """POST a prepared request body (JSON, NPZ1 or RAW1) → predictions."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{model_name}:predict",
        data=body, headers={"Content-Type": "application/octet-stream"},
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return _parse_response(resp.read())


def rest_predict(port: int, features: dict[str, np.ndarray],
                 model_name: str = "model") -> np.ndarray:
    """JSON round trip of ``features`` → predictions."""
    return rest_send(port, prepare_body(features, "json"), model_name)


def make_grpc_stub(port: int):
    """A stub of `server.GRPC_METHOD` on one channel, to hold across
    calls. Needs ``grpcio``."""
    import grpc

    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    return channel.unary_unary(GRPC_METHOD,
                               request_serializer=lambda b: b,
                               response_deserializer=lambda b: b)


def grpc_send(stub, body: bytes) -> np.ndarray:
    """One prepared body over gRPC → predictions."""
    return _parse_response(stub(body, timeout=60.0))


def grpc_send_future(stub, body: bytes):
    """Send without waiting; resolve with `grpc_future_result`."""
    return stub.future(body, timeout=60.0)


def grpc_future_result(future) -> np.ndarray:
    return _parse_response(future.result())


def grpc_predict_pipelined(stub, bodies: list[bytes]) -> list[np.ndarray]:
    """Every body sent before any answer is awaited, on one channel: the
    server's micro-batcher may coalesce them."""
    pending = [grpc_send_future(stub, b) for b in bodies]
    return [grpc_future_result(f) for f in pending]


def grpc_predict(port: int, features: dict[str, np.ndarray]) -> np.ndarray:
    """JSON round trip of ``features`` over gRPC → predictions."""
    return grpc_send(make_grpc_stub(port), prepare_body(features, "json"))


def auc(labels: np.ndarray, probs: np.ndarray) -> float:
    """The exact ROC AUC (the Mann-Whitney statistic, ties at half)."""
    labels = np.asarray(labels) > 0.5
    probs = np.asarray(probs, np.float64)
    _, inv, counts = np.unique(probs, return_inverse=True,
                               return_counts=True)
    # the mean rank of each distinct value, given to each of its ties
    ends = np.cumsum(counts)
    ranks = (ends - (counts - 1) / 2.0)[inv]
    n_pos = int(labels.sum())
    n_neg = len(labels) - n_pos
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def benchmark_serving(predict_fn, features: dict[str, np.ndarray],
                      labels: np.ndarray | None = None, warmup: int = 2,
                      iters: int = 10) -> dict[str, float]:
    """``warmup`` calls of ``predict_fn(features)``, then ``iters`` timed
    ones → {batch, latency_ms_mean, latency_ms_p50, latency_ms_p99} and,
    with ``labels`` of both classes, the answers' ``auc``."""
    for _ in range(warmup):
        predict_fn(features)
    lat = []
    probs = None
    for _ in range(iters):
        t0 = time.perf_counter()
        probs = predict_fn(features)
        lat.append(time.perf_counter() - t0)
    out = {
        "batch": float(len(probs)),
        "latency_ms_mean": float(np.mean(lat) * 1e3),
        "latency_ms_p50": float(np.percentile(lat, 50) * 1e3),
        "latency_ms_p99": float(np.percentile(lat, 99) * 1e3),
    }
    if labels is not None and len(set(np.asarray(labels).tolist())) > 1:
        out["auc"] = auc(labels, probs)
    return out
