"""The streaming input pipeline (counterpart of ``recsys_tpu/data/loader.py``):
npz shards → fixed-size host batches → tensors on the device.

- `ShardSource`: epochs over ``.npz`` shard files, each epoch a shuffled
  shard order and a random permutation inside each shard (drawn from
  ``default_rng([seed, epoch])``; the permutation applied by
  `native.gather_rows`), fixed-size batches with the rows left over from
  one shard carried into the next, and the remainder dropped at the end of
  an epoch. For the same arguments it yields the same batches, bit for
  bit, as the JAX package's ``ShardSource``.
- `device_prefetch`: two threads, one drawing host batches and one moving
  them to the device, ``depth`` batches ahead of the consumer. On CUDA a
  batch crosses through a ring of pinned host buffers on a copy stream of
  its own, and the consumer's stream waits on the copy's event before the
  batch is used, so the copy of the next batch overlaps the current step.
  An exception in either thread is raised in the consumer; a consumer that
  stops early stops both threads.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from recsys_tpu_torch.data import native


#: the most bytes of loaded shards a `ShardSource` keeps in memory
CACHE_BYTES = 8 << 30


class ShardSource:
    """Iterates fixed-size batches over a set of npz shards, forever
    (``num_epochs`` < 0) or for ``num_epochs`` epochs. ``keys`` picks the
    arrays to read (default: all); ``cache`` keeps loaded shards in memory
    up to `CACHE_BYTES` bytes."""

    def __init__(self, shard_paths: list[str], batch_size: int, *,
                 shuffle: bool = True, seed: int = 0, num_epochs: int = -1,
                 keys: tuple[str, ...] | None = None, cache: bool = True):
        if not shard_paths:
            raise ValueError("no shards")
        self.shard_paths = list(shard_paths)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_epochs = num_epochs
        self.keys = keys
        self.cache = cache
        self._cache: dict[int, dict[str, np.ndarray]] = {}
        self._cache_bytes = 0

    def _load_shard(self, si: int) -> dict[str, np.ndarray]:
        cached = self._cache.get(si)
        if cached is not None:
            return cached
        with np.load(self.shard_paths[si]) as z:
            data = {k: z[k] for k in (self.keys or tuple(z.files))}
        if self.cache:
            nbytes = sum(v.nbytes for v in data.values())
            if self._cache_bytes + nbytes <= CACHE_BYTES:
                self._cache[si] = data
                self._cache_bytes += nbytes
        return data

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        epoch = 0
        while self.num_epochs < 0 or epoch < self.num_epochs:
            rng = np.random.default_rng([self.seed, epoch])
            order = np.arange(len(self.shard_paths))
            if self.shuffle:
                rng.shuffle(order)
            carry: dict[str, np.ndarray] | None = None
            for si in order:
                data = self._load_shard(int(si))
                n = len(next(iter(data.values())))
                if self.shuffle:
                    perm = rng.permutation(n)
                    data = {k: native.gather_rows(v, perm)
                            for k, v in data.items()}
                if carry is not None:
                    data = {k: np.concatenate([carry[k], v])
                            for k, v in data.items()}
                    n = len(next(iter(data.values())))
                nb = n // self.batch_size
                for b in range(nb):
                    lo = b * self.batch_size
                    yield {k: v[lo:lo + self.batch_size]
                           for k, v in data.items()}
                rem = n - nb * self.batch_size
                carry = ({k: v[n - rem:] for k, v in data.items()}
                         if rem else None)
            epoch += 1


def _is_int(a: np.ndarray) -> bool:
    return np.issubdtype(a.dtype, np.integer)


class _CudaStager:
    """Host batch → device tensors through pinned buffers on a copy stream.

    The pinned buffers form a ring of ``slots`` batches, allocated once per
    (slot, key, shape, type) and reused; a slot is written again only after
    the event recorded behind its last copy has completed. Each batch goes
    to fresh device tensors, allocated on the copy stream and marked used by
    the consumer's stream (``record_stream``), so the allocator never hands
    their memory to a later copy while the consumer may still read them.
    Integer arrays cross as they are (the loader's int32) and are widened
    to int64, the gathers' index type, on the card."""

    def __init__(self, device: torch.device, consumer: torch.cuda.Stream,
                 slots: int):
        self.device = device
        self.consumer = consumer
        self.stream = torch.cuda.Stream(device)
        self.ring: list[dict] = [{} for _ in range(slots)]
        self.events: list[torch.cuda.Event | None] = [None] * slots
        self.i = 0

    def __call__(self, batch: dict[str, np.ndarray]):
        slot = self.i % len(self.ring)
        self.i += 1
        if self.events[slot] is not None:
            self.events[slot].synchronize()   # its last copy has left it
        bufs = self.ring[slot]
        out = {}
        with torch.cuda.stream(self.stream):
            for k, v in batch.items():
                host = torch.from_numpy(np.ascontiguousarray(v))
                pinned = bufs.get(k)
                if (pinned is None or pinned.shape != host.shape
                        or pinned.dtype != host.dtype):
                    pinned = torch.empty(host.shape, dtype=host.dtype,
                                         pin_memory=True)
                    bufs[k] = pinned
                # numpy's copy, one memcpy on this thread: torch's CPU copy_
                # fans out to the intra-op thread pool, whose threads then
                # fight the shuffle gather's threads for the host's cores
                pinned.numpy()[...] = v
                t = pinned.to(self.device, non_blocking=True)
                if _is_int(v):
                    t = t.to(torch.int64)
                t.record_stream(self.consumer)
                out[k] = t
            event = torch.cuda.Event()
            event.record(self.stream)
        self.events[slot] = event
        return out, event


def _cpu_stage(batch: dict[str, np.ndarray]):
    return ({k: torch.from_numpy(np.ascontiguousarray(v)).to(torch.int64)
             if _is_int(v) else torch.from_numpy(np.ascontiguousarray(v))
             for k, v in batch.items()}, None)


class _Failure:
    """An exception raised in a worker thread, on its way to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


_END = object()
_POLL_S = 0.1


def device_prefetch(host_iter, device, depth: int = 2
                    ) -> Iterator[dict[str, torch.Tensor]]:
    """Yield each host batch of ``host_iter`` (dicts of numpy arrays) as a
    dict of tensors on ``device``, integer arrays as int64.

    A generation thread draws host batches into a queue of ``depth``; a
    transfer thread moves them to the device into a second queue of
    ``depth``. On CUDA the transfer runs on its own stream through pinned
    buffers (`_CudaStager`), and before a batch is yielded the stream that
    was current on the calling thread waits on its copy's event; on the
    CPU the same two threads run, with no pinning and no streams.

    An exception in either thread is raised here, in the consumer. A
    consumer that stops early (``break``, ``close()``, the generator
    dropped) sets a stop flag; both threads put with timeouts and check it,
    so neither stays blocked."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:           # the index the threads run on
            device = torch.device("cuda", torch.cuda.current_device())
        consumer = torch.cuda.current_stream(device)
        stage = _CudaStager(device, consumer, depth + 2)
    elif device.type == "cpu":
        consumer, stage = None, _cpu_stage
    else:
        raise ValueError(f"device_prefetch: want a cuda or cpu device, "
                         f"got {device}")
    stop = threading.Event()
    host_q: queue.Queue = queue.Queue(maxsize=depth)
    dev_q: queue.Queue = queue.Queue(maxsize=depth)

    def put(q: queue.Queue, item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                pass
        return False

    def generate():
        try:
            for batch in host_iter:
                if not put(host_q, batch):
                    return
            put(host_q, _END)
        except BaseException as e:  # noqa: BLE001 - handed to the consumer
            put(host_q, _Failure(e))

    def transfer():
        try:
            if device.type == "cuda":
                torch.cuda.set_device(device)
            while not stop.is_set():
                try:
                    item = host_q.get(timeout=_POLL_S)
                except queue.Empty:
                    continue
                if item is _END or isinstance(item, _Failure):
                    put(dev_q, item)
                    return
                if not put(dev_q, stage(item)):
                    return
        except BaseException as e:  # noqa: BLE001 - handed to the consumer
            put(dev_q, _Failure(e))

    threads = [threading.Thread(target=generate, daemon=True,
                                name="device_prefetch-generate"),
               threading.Thread(target=transfer, daemon=True,
                                name="device_prefetch-transfer")]
    for t in threads:
        t.start()
    try:
        while True:
            try:
                item = dev_q.get(timeout=_POLL_S)
            except queue.Empty:
                if not threads[1].is_alive() and dev_q.empty():
                    raise RuntimeError("device_prefetch: the transfer "
                                       "thread ended without a result")
                continue
            if item is _END:
                return
            if isinstance(item, _Failure):
                raise item.exc
            batch, event = item
            if event is not None:
                consumer.wait_event(event)
            yield batch
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
