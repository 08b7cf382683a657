"""Row-sharded embedding lookup over the ``model`` mesh axis (counterpart of
``recsys_tpu/parallel/sharded_embedding.py``).

A packed ``[V, W]`` table too large to copy to every device is split by
rows over the ``model`` axis, member m holding rows ``[m·V/E, (m+1)·V/E)``,
and a lookup becomes an exchange between the members that share a batch
(one data shard).

**a2a_embedding_lookup** (the product path), dedup + all-to-all:

1. the flat id stream [N] of the data shard's batch is split into E chunks,
   one per member, padded with the out-of-range id V where E does not
   divide N;
2. each member sorts its chunk and deduplicates it;
3. the unique ids are packed per owner into ``[E, cap]`` and exchanged
   (`collectives.all_to_all`);
4. each owner reads the rows it received from its shard through
   `table.table_gather`: on the card the forward is the row gather (S1,
   ``ops/row_gather.py``) and the backward the segment sum (K2's contract,
   ``ops/segment_sum.py``: the dense ``[V/E, W]`` sum of the returned rows'
   gradients per local row); the rows go back by a second all-to-all;
5. each member un-deduplicates and un-sorts its chunk (plain gathers and
   index ops), and an all-gather over the axis rebuilds the ``[N, W]``
   rows.

The capacity ``cap`` per (sender, owner) pair is ``ceil(cap_factor·nc/E)``
for a chunk of nc ids, or nc with ``exact`` (no overflow possible). Unique
ids beyond an owner's capacity read as zero rows and drop their gradients;
`a2a_overflow` counts them for a batch on the host, so the drivers can
refuse such a run (``train/spmd_loop.resolve_a2a_exact``).

**psum_embedding_lookup**, the oracle: every member reads its hits of the
whole stream and a psum over the axis adds the pieces. Exact and simple,
but it moves the whole ``[N, W]`` activation through an all-reduce.

Every function runs on every member of the axis at once, with the same
``gids``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from recsys_tpu_torch.embeddings import table as emb_table
from recsys_tpu_torch.parallel import collectives as C
from recsys_tpu_torch.parallel.collectives import Axis


def shard_rows_of(total_rows: int, num_shards: int) -> int:
    if total_rows % num_shards != 0:
        raise ValueError(
            f"padded vocab {total_rows} not divisible by model axis "
            f"{num_shards}")
    return total_rows // num_shards


def _owned(local_table: torch.Tensor, gids: torch.Tensor, axis: Axis):
    """(local row ids with misses at 0, hit mask) of global ``gids``."""
    shard_rows = local_table.shape[0]
    local = gids - axis.index * shard_rows
    hit = (local >= 0) & (local < shard_rows)
    return torch.where(hit, local, torch.zeros_like(local)), hit


def psum_embedding_lookup(local_table: torch.Tensor, gids: torch.Tensor,
                          axis: Axis) -> torch.Tensor:
    """``[V/E, W]`` shard + ``[B, F]`` global ids → ``[B, F, W]`` rows."""
    safe, hit = _owned(local_table, gids, axis)
    emb = emb_table.table_gather(local_table, safe)
    emb = torch.where(hit[..., None], emb, torch.zeros_like(emb))
    return C.psum(emb, axis)


def sharded_linear_sum(local_w: torch.Tensor, bias: torch.Tensor,
                       gids: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The wide term over a ``[V/E]`` shard of the weights: Σ_f w[gid_f]
    + b → [B, 1] (the shard read through its ``[V/E, 1]`` view)."""
    safe, hit = _owned(local_w, gids, axis)
    w = emb_table.table_gather(local_w.view(-1, 1), safe)[..., 0]
    w = torch.where(hit, w, torch.zeros_like(w))
    return C.psum(w.sum(dim=1, keepdim=True), axis) + bias


def a2a_capacity(n_flat: int, num_shards: int, cap_factor: float,
                 exact: bool) -> int:
    """Per-(sender, owner) id capacity. ``exact`` sizes for the worst case
    (every unique id of a chunk owned by one shard): no overflow."""
    nc = -(-n_flat // num_shards)
    if exact:
        return nc
    return min(nc, max(1, math.ceil(cap_factor * nc / num_shards)))


def a2a_embedding_lookup(local_table: torch.Tensor, gids: torch.Tensor,
                         axis: Axis, cap_factor: float = 2.0,
                         exact: bool = False) -> torch.Tensor:
    """``[V/E, W]`` shard + ``[B, F]`` int64 global ids (the same on every
    member) → ``[B, F, W]`` rows, differentiable in the shard."""
    e, m = axis.size, axis.index
    shard_rows, w = local_table.shape
    v_total = shard_rows * e
    b, f = gids.shape
    n = b * f
    dev = gids.device
    if v_total >= 2 ** 31:
        raise ValueError(f"a2a_embedding_lookup: {v_total} rows do not fit "
                         "the exchange's int32 ids")

    flat = gids.reshape(-1)
    nc = -(-n // e)                       # chunk length per member
    if nc * e != n:
        # pad with an out-of-range id: it reads as a zero row, grads drop
        flat = torch.cat([flat, flat.new_full((nc * e - n,), v_total)])
    cap = a2a_capacity(nc * e, e, cap_factor, exact)

    # 1. my chunk (members process disjoint slices of the id stream)
    chunk = flat[m * nc:(m + 1) * nc]

    # 2. sort + dedup: duplicates collapse onto their first occurrence
    sid, order = torch.sort(chunk)
    first = torch.ones_like(sid, dtype=torch.bool)
    first[1:] = sid[1:] != sid[:-1]
    urank = torch.cumsum(first, 0) - 1                    # [nc]
    # compaction: usort[urank[p]] = sid[p], ascending; the slots left over
    # stay at the out-of-range sentinel, so they route nowhere
    usort = torch.full((nc,), v_total, dtype=sid.dtype, device=dev)
    usort[urank] = sid

    # 3. pack per-owner send buffers [E, cap] and exchange ids
    bounds = torch.arange(e + 1, device=dev) * shard_rows
    start = torch.searchsorted(usort, bounds[:-1])
    end = torch.searchsorted(usort, bounds[1:])
    k = torch.arange(cap, device=dev)[None, :]
    idx = start[:, None] + k
    valid = k < (end - start)[:, None]
    send_ids = torch.where(valid, usort[idx.clamp(0, nc - 1)],
                           torch.full_like(idx, v_total))
    # the ids cross the wire as int32 (the JAX package's exchange: E·cap·4
    # bytes), and are widened again for the gather
    recv_ids = C.all_to_all(send_ids.to(torch.int32), axis).to(torch.int64)

    # 4. owner-side gather: S1 forward, K2 backward on the card
    safe, hit = _owned(local_table, recv_ids, axis)
    rows = emb_table.table_gather(local_table, safe)       # [E, cap, W]
    rows = torch.where(hit[..., None], rows, torch.zeros_like(rows))
    got = C.all_to_all(rows, axis)

    # 5. un-dedup + un-sort my chunk, then reassemble the full stream: the
    # index maps compose first (chunk position → sorted position → unique
    # rank → wire row), so the rows take ONE gather, whose backward sums
    # only the real duplicates (the unused unique slots, most of a chunk
    # at one member, would all pile onto one row)
    owner = (usort // shard_rows).clamp(0, e - 1)
    slot = torch.arange(nc, device=dev) - start[owner]
    ok = (slot >= 0) & (slot < cap) & (usort < v_total)
    uflat = torch.where(ok, owner * cap + slot, torch.zeros_like(slot))
    unsort = torch.empty_like(order)
    unsort[order] = torch.arange(nc, device=dev)
    src = urank[unsort]                   # unique rank of each position
    chunk_rows = got.reshape(e * cap, w)[uflat[src]]       # [nc, W]
    chunk_rows = torch.where(ok[src][:, None], chunk_rows,
                             torch.zeros_like(chunk_rows))
    full = C.all_gather(chunk_rows, axis)
    return full[:n].reshape(b, f, w)


def a2a_overflow(gids, num_shards: int, shard_rows: int,
                 cap_factor: float = 2.0) -> int:
    """Host-side diagnostic: how many unique ids of a batch would overflow
    the per-owner capacity at this ``cap_factor`` (0 == lossless)."""
    flat = np.asarray(gids).reshape(-1)
    nc = -(-flat.size // num_shards)
    cap = a2a_capacity(nc * num_shards, num_shards, cap_factor, exact=False)
    dropped = 0
    for c in range(num_shards):
        chunk = flat[c * nc:(c + 1) * nc]
        uniq = np.unique(chunk)
        owners = np.clip(uniq // shard_rows, 0, num_shards - 1)
        counts = np.bincount(owners, minlength=num_shards)
        dropped += int(np.maximum(counts - cap, 0).sum())
    return dropped
