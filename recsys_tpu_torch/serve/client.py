"""REST serving client (counterpart of ``recsys_tpu/serve/client.py``):
build a request body, send it, parse the predictions. The gRPC client is
not ported yet."""

from __future__ import annotations

import io
import json
import urllib.request

import numpy as np

from recsys_tpu_torch.serve.server import (BINARY_MAGIC, RAW_MAGIC,
                                           encode_raw, parse_raw)


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
