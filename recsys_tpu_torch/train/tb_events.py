"""TensorBoard event files without TensorFlow (counterpart of
``recsys_tpu/train/tb_events.py``; numpy and the standard library only).

Records are framed in the TFRecord wire format (length and masked crc32c)
and the Event, Summary and HistogramProto messages are hand-encoded
protobuf, so any stock TensorBoard opens the ``events.out.tfevents.*``
files.

- `EventWriter`: ``add_scalar``, ``add_scalars``, ``add_histogram``,
  ``flush`` and ``close``.
- `jsonl_to_events(model_dir)`: a `train.summaries.ScalarWriter` JSONL
  stream as an event file beside it; from the command line
  ``python -m recsys_tpu_torch.train.tb_events <model_dir> ...``.
- `train.summaries.ScalarWriter` tees into an `EventWriter`, so every
  training run's ``model_dir`` opens in TensorBoard.

Format:
- record: u64-LE length, u32-LE masked crc32c of the length bytes, the
  payload, u32-LE masked crc32c of the payload; mask(c) = ((c >> 15 |
  c << 17) + 0xa282ead8) mod 2^32, crc32c the Castagnoli CRC (reflected
  polynomial 0x82F63B78);
- the first record is ``Event{file_version: "brain.Event:2"}``;
- scalars: ``Event{wall_time, step, summary{value{tag, simple_value}}}``;
- histograms: ``value{tag, histo{min, max, num, sum, sum_squares,
  bucket_limit[], bucket[]}}``.
"""

from __future__ import annotations

import os
import socket
import struct
import time

import numpy as np

# ---------------------------------------------------------------------------
# crc32c (Castagnoli, reflected polynomial 0x82F63B78) — table-driven
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc_table() -> list[int]:
    global _CRC_TABLE
    if not _CRC_TABLE:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return ((c >> 15) | (c << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf encoding (wire types 0=varint, 1=64-bit, 2=bytes, 5=32-bit)
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _f_varint(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _f_packed_doubles(field: int, vals) -> bytes:
    body = b"".join(struct.pack("<d", float(v)) for v in vals)
    return _f_bytes(field, body)


def _histogram_proto(values: np.ndarray, bins: int = 30) -> bytes:
    v = np.asarray(values, np.float64).ravel()
    if v.size == 0:
        v = np.zeros(1)
    counts, edges = np.histogram(v, bins=bins)
    # TF's HistogramProto: bucket_limit[i] is the RIGHT edge of bucket i
    return b"".join([
        _f_double(1, float(v.min())),
        _f_double(2, float(v.max())),
        _f_double(3, float(v.size)),
        _f_double(4, float(v.sum())),
        _f_double(5, float((v * v).sum())),
        _f_packed_doubles(6, edges[1:]),
        _f_packed_doubles(7, counts),
    ])


def _summary_value_scalar(tag: str, value: float) -> bytes:
    return _f_bytes(1, _f_bytes(1, tag.encode()) + _f_float(2, float(value)))


def _summary_value_histo(tag: str, values: np.ndarray) -> bytes:
    return _f_bytes(1, _f_bytes(1, tag.encode())
                    + _f_bytes(5, _histogram_proto(values)))


def _event(step: int | None, summary: bytes | None,
           file_version: str | None = None,
           wall_time: float | None = None) -> bytes:
    out = [_f_double(1, time.time() if wall_time is None else wall_time)]
    if step is not None:
        out.append(_f_varint(2, int(step)))
    if file_version is not None:
        out.append(_f_bytes(3, file_version.encode()))
    if summary is not None:
        out.append(_f_bytes(5, summary))
    return b"".join(out)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


class EventWriter:
    """Append-only ``events.out.tfevents`` writer (TensorBoard-compatible)."""

    #: process-wide monotone counter so two writers created in the same
    #: directory within the same second (fast successive runs/tests) never
    #: collide on one filename — TF's writer disambiguates with pid + a
    #: uid counter the same way.
    _uid = 0

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        EventWriter._uid += 1
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}.{EventWriter._uid}"
                f"{filename_suffix}")
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "wb")
        self._write_record(_event(None, None, file_version="brain.Event:2"))

    def _write_record(self, payload: bytes) -> None:
        head = struct.pack("<Q", len(payload))
        self._f.write(head)
        self._f.write(struct.pack("<I", _masked_crc(head)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: float | None = None) -> None:
        self._write_record(_event(step, _summary_value_scalar(tag, value),
                                  wall_time=wall_time))

    def add_scalars(self, scalars: dict[str, float], step: int) -> None:
        summary = b"".join(_summary_value_scalar(t, v)
                           for t, v in scalars.items())
        self._write_record(_event(step, summary))

    def add_histogram(self, tag: str, values, step: int) -> None:
        self._write_record(_event(step, _summary_value_histo(
            tag, np.asarray(values))))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


def jsonl_to_events(model_dir: str, out_dir: str | None = None) -> str:
    """Convert a ScalarWriter ``scalars.jsonl`` stream into a tfevents file
    (for runs recorded before the tee existed, or re-exports)."""
    import json

    w = EventWriter(out_dir or model_dir, filename_suffix=".converted")
    with open(os.path.join(model_dir, "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            step = int(rec.pop("step"))
            wall = rec.pop("wall_time", None)
            for tag, v in rec.items():
                if isinstance(v, (int, float)):
                    w.add_scalar(tag, float(v), step, wall_time=wall)
    w.close()
    return w.path


if __name__ == "__main__":
    import sys

    for d in sys.argv[1:]:
        print(jsonl_to_events(d))
