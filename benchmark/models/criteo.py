"""What the Criteo models of the benchmark share: the feature schema of a
configuration file, the plain layers the reference models are built from,
and the map of the benchmark's weights into the port's parameter tree.

The reference keeps every tensor in the configuration's own field order:
one embedding table ``emb`` [V, D] and one wide vector ``wide`` [V] over
all fields, offset by field. The port's split engine keeps two packed
tables (``tables/small``, ``tables/big``: [V_pad, D+1], the wide weight in
the last column), its fields in engine order (the fields of vocab <=
``split_threshold`` first, then the rest, each group in field order), and
the first dense layer's rows and the CIN filters in that order. `pack`
puts a tree of the reference's layout into the port's; it is linear, so it
maps gradients and changes of the weights as it maps the weights.

Plain PyTorch and NumPy: imports nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------

def field_vocabs(config: dict) -> list[int]:
    """Vocabulary of each field in field order: each continuous field's
    buckets (its boundaries + 1), then the hashed categorical fields."""
    return ([len(b) + 1 for b in config["cont_boundaries"]]
            + list(config["cat_vocabs"]))


def offsets(vocabs) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(vocabs)[:-1]]).astype(np.int64)


def engine_parts(config: dict) -> dict[str, list[int]]:
    """The split engine's fields of each table, in field order."""
    vocabs = field_vocabs(config)
    thr = config["split_threshold"]
    return {"small": [f for f, v in enumerate(vocabs) if v <= thr],
            "big": [f for f, v in enumerate(vocabs) if v > thr]}


def engine_order(config: dict) -> list[int]:
    parts = engine_parts(config)
    return parts["small"] + parts["big"]


# ---------------------------------------------------------------------------
# weights of the reference's layout
# ---------------------------------------------------------------------------

def table_spec(config: dict) -> list:
    """(path, shape, init) of the tables: embeddings truncated-normal with
    standard deviation 1/sqrt(D) (TF's embedding_column), wide weights
    glorot-uniform over a [V, 1] kernel, the shared bias zero."""
    v, d = sum(field_vocabs(config)), config["embedding_dim"]
    return [(("emb",), (v, d), ("trunc_normal", d ** -0.5)),
            (("wide",), (v,), ("glorot", v, 1)),
            (("b",), (), ("zeros",))]


def dense_spec(path: tuple, n_in: int, n_out: int) -> list:
    return [(path + ("w",), (n_in, n_out), ("glorot", n_in, n_out)),
            (path + ("b",), (n_out,), ("zeros",))]


def mlp_spec(config: dict, n_in: int) -> list:
    spec, d = [], n_in
    for i, h in enumerate(config["deep_layers"]):
        spec += dense_spec(("dnn", "layers", i, "dense"), d, h)
        if config["use_bn"]:
            spec += [(("dnn", "layers", i, "bn", "scale"), (h,), ("ones",)),
                     (("dnn", "layers", i, "bn", "offset"), (h,), ("zeros",))]
        d = h
    return spec


def get(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def put(tree: dict, path: tuple, value) -> None:
    """Set ``tree[path]``, making dicts, and lists for integer keys."""
    node = tree
    for k, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= k:
                node.append(None)
            if node[k] is None:
                node[k] = [] if isinstance(nxt, int) else {}
            node = node[k]
        else:
            node = node.setdefault(k, [] if isinstance(nxt, int) else {})
    if isinstance(node, list):
        while len(node) <= path[-1]:
            node.append(None)
    node[path[-1]] = value


def paths(tree, prefix: tuple = ()):
    """(path, leaf) of a tree of dicts and lists, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from paths(v, prefix + (i,))
    else:
        yield prefix, tree


def path_name(path: tuple) -> str:
    return "/".join(str(k) for k in path)


def make_weights(spec: list, gen: torch.Generator, device) -> dict:
    """A tree of the reference's layout from ``spec``, drawn on ``device``
    in two calls: one truncated normal for every ``trunc_normal`` leaf, one
    uniform for every ``glorot`` leaf, each leaf a slice scaled to its
    limit."""
    tree: dict = {}
    for kind in ("trunc_normal", "glorot"):
        leaves = [(p, s, i) for p, s, i in spec if i[0] == kind]
        total = sum(int(np.prod(s)) for _, s, _ in leaves)
        if not total:
            continue
        flat = torch.empty((total,), dtype=torch.float32, device=device)
        if kind == "trunc_normal":
            torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0,
                                        generator=gen)
        else:
            flat.uniform_(-1.0, 1.0, generator=gen)
        lo = 0
        for p, s, init in leaves:
            n = int(np.prod(s))
            scale = (init[1] if kind == "trunc_normal"
                     else (6.0 / (init[1] + init[2])) ** 0.5)
            put(tree, p, flat[lo:lo + n].view(s).mul(scale))
            lo += n
    for p, s, init in spec:
        if init[0] in ("zeros", "ones"):
            fill = torch.ones if init[0] == "ones" else torch.zeros
            put(tree, p, fill(s, dtype=torch.float32, device=device))
    return tree


# ---------------------------------------------------------------------------
# the port's layout
# ---------------------------------------------------------------------------

def _packed_table(config: dict, canon: dict, part: str, rows: int):
    """One of the split engine's tables [rows, D+1] from ``canon``'s emb
    and wide: its fields' rows in engine order, zero below."""
    vocabs = field_vocabs(config)
    offs = offsets(vocabs)
    fields = engine_parts(config)[part]
    emb, wide = canon["emb"], canon["wide"]
    src = torch.cat([torch.arange(offs[f], offs[f] + vocabs[f],
                                  device=emb.device) for f in fields])
    out = torch.zeros((rows, emb.shape[1] + 1), dtype=emb.dtype,
                      device=emb.device)
    out[:src.numel(), :-1] = emb.index_select(0, src)
    out[:src.numel(), -1] = wide.index_select(0, src)
    return out


def _rows_by_field(w: torch.Tensor, order, inner: int) -> torch.Tensor:
    """``w`` [F·inner, H] with its field-major row blocks in ``order``."""
    f = len(order)
    idx = torch.as_tensor(order, device=w.device)
    return w.reshape(f, inner, -1).index_select(0, idx).reshape(w.shape)


def pack(config: dict, canon: dict, template) -> dict:
    """A tree shaped as the port's parameter tree ``template`` (tensors on
    the 'meta' device give the shapes), filled from the reference-layout
    tree ``canon`` (weights, gradients or changes of them): new tensors,
    none of which shares storage with ``canon``."""
    order = engine_order(config)
    n_fields, d = len(order), config["embedding_dim"]
    out: dict = {}
    for path, leaf in paths(template):
        if path in (("tables", "small"), ("tables", "big")):
            value = _packed_table(config, canon, path[1], leaf.shape[0])
        elif path == ("tables", "b"):
            value = canon["b"]
        elif path == ("dnn", "layers", 0, "dense", "w"):
            value = _rows_by_field(get(canon, path), order, d)
        elif path[0] == "cin" and path[2] == "w":
            w = get(canon, path)
            if path[1] == 0:     # rows (p, q) over two fields
                idx = torch.as_tensor(order, device=w.device)
                value = (w.reshape(n_fields, n_fields, -1)[idx][:, idx]
                         .reshape(w.shape))
            else:                # rows (p, q): p a field, q a feature map
                value = _rows_by_field(w, order, w.shape[0] // n_fields)
        else:
            value = get(canon, path)
        if tuple(value.shape) != tuple(leaf.shape):
            raise ValueError(f"pack: {path_name(path)} is "
                             f"{tuple(value.shape)}, the port's tree holds "
                             f"{tuple(leaf.shape)}")
        put(out, path, value.clone(memory_format=torch.contiguous_format))
    return out


# ---------------------------------------------------------------------------
# plain layers of the reference
# ---------------------------------------------------------------------------

def lookup(config: dict, canon: dict, ids: torch.Tensor):
    """(emb [B, F, D], wide [B, F]) of field-local ids [B, F]."""
    offs = torch.as_tensor(offsets(field_vocabs(config)), device=ids.device)
    gids = ids + offs
    return canon["emb"][gids], canon["wide"][gids]


def dense(p: dict, x: torch.Tensor, mm) -> torch.Tensor:
    return mm(x, p["w"]) + p["b"]


def mlp(config: dict, layers: list, x: torch.Tensor, masks, mm):
    """[dense → relu → batch norm (batch statistics, biased variance) →
    dropout] per layer, the masks given (True keeps)."""
    keep = 1.0 - config["dropout"]
    h = x
    for layer, mask in zip(layers, masks, strict=True):
        h = torch.relu(dense(layer["dense"], h, mm))
        if config["use_bn"]:
            mean = h.mean(dim=0)
            var = (h - mean).square().mean(dim=0)
            h = ((h - mean) * torch.rsqrt(var + config["bn_eps"])
                 * layer["bn"]["scale"] + layer["bn"]["offset"])
        h = torch.where(mask, h / keep, torch.zeros_like(h))
    return h


def fm_pairwise(emb: torch.Tensor) -> torch.Tensor:
    """Σ_{f<g} <e_f, e_g> → [B, 1]."""
    s = emb.sum(dim=1)
    return 0.5 * (s.square() - emb.square().sum(dim=1)).sum(dim=1,
                                                            keepdim=True)


# ---------------------------------------------------------------------------
# work, for the roofline readers
# ---------------------------------------------------------------------------

def expected_distinct(vocab: int, draws: int, skew: float) -> float:
    """Expected number of distinct ids among ``draws`` ids of one field,
    each ``floor(vocab · u^skew)``: Σ_v 1 − (1 − p_v)^draws with
    p_v = ((v+1)/vocab)^(1/skew) − (v/vocab)^(1/skew)."""
    edges = (np.arange(vocab + 1, dtype=np.float64) / vocab) ** (1.0 / skew)
    p = np.diff(edges)
    return float(np.sum(-np.expm1(draws * np.log1p(-np.minimum(p, 1 - 1e-16)))))


def embedding_work(config: dict, traffic: dict) -> list[tuple[float, float]]:
    """(bytes, flops) of each of a training step's embedding kernels: the
    row gather (S1) and the segment sum (K1/K2) of each of the split
    engine's two tables. Ids count 4 bytes (the narrowest type that holds
    the table's rows), rows and gradients float32, every input read once
    and every output written once:

    - gather: the ids, the distinct rows they name (their expected number
      under the traffic's skew), the [n, D+1] rows written;
    - segment sum: the ids, the [n, D+1] gradients, each distinct row of
      the sum written once. The zero fill of the rows no id touches is a
      memset of its own in the trace, outside the kernels timed against
      this bound."""
    vocabs = field_vocabs(config)
    w = config["embedding_dim"] + 1
    b = traffic["batch"]
    work = []
    for fields in engine_parts(config).values():
        if not fields:
            continue
        n = b * len(fields)
        distinct = sum(expected_distinct(vocabs[f], b, traffic["id_skew"])
                       for f in fields)
        work.append((4 * n + 4 * w * (distinct + n), 0.0))      # gather
        work.append((4 * n + 4 * n * w + 4 * w * distinct, n * w))  # sum
    return work


def dnn_flops(config: dict, n_in: int) -> float:
    """Forward flops of the MLP tower and its output layer: 2 per
    multiply-add of each dense layer."""
    macs, d = 0, n_in
    for h in config["deep_layers"]:
        macs += d * h
        d = h
    return 2.0 * (macs + d)
