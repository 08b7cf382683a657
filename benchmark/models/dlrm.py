"""DLRM-DCNv2's plain reference (the model of MLPerf Training's
recommendation benchmark: github.com/mlcommons/training
``recommendation_v2/torchrec_dlrm``; DLRM, arXiv:1906.00091; DCN-V2,
arXiv:2008.13535), its first training steps, its work counts and its
weights, laid out as the port's parameter tree.

For a row with dense features x [13] and, for each of the F = 26 fields, a
bag of ``multi_hot_sizes[f]`` ids:

    e_f    = Σ_{i in bag f} table[offset_f + id_i]                 [D = 128]
    h      = relu(dense(... relu(dense(x))))                (512-256-128)
    x_0    = [h, e_1, ..., e_F]                                (27·128 wide)
    x_l+1  = x_0 ⊙ (W_l (V_l x_l) + b_l) + x_l        (3 layers, rank 512)
    logit  = dense(relu(dense(... relu(dense(x_3)))))   (1024-1024-512-256-1)

trained with the mean sigmoid cross-entropy and Adagrad at a constant
learning rate: one accumulator a row on the table (row-wise), one an
element on the dense leaves, each starting at 0:

    a ← a + mean_row(g²) (row-wise) or g² (elementwise)
    p ← p − lr·g / (√a + ε)

`train_steps` is the plain training of a cell's first steps: autograd on
the gathered rows and the dense leaves, float32 with TF32 off
(``precision='fp64'`` a witness in float64, ``'tf32'`` the control: every
product of a dense layer rounded to TF32, `reference.matmul`), each step's
rows drawn from the port's per-step seed. The table's gradient is dense,
[V, D], and its update runs over every row; both are made a block of rows at
a time (`BLOCK_ROWS`), so that a card holds them beside the table.
``fault='half_batch'`` plants a fault: the mean loss over the first half
of each batch only.

The layout of the weights is the port's tree (``recsys_tpu_torch/models/
dlrm.py``): {'table': [Σ rows, D], 'bottom'/'top': {'layers': [{'dense':
{'w' [in, out], 'b'}}]}, 'cross': [{'v' [dim, rank], 'w' [rank, dim], 'b'}],
'final': {'w', 'b'}}, so no map is needed between the two.

Plain PyTorch: imports nothing of the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import draws, reference
from benchmark.models import criteo

#: rows of the table's dense gradient made at a time
BLOCK_ROWS = 1 << 21
#: the comparison's group of each top-level key: the table the row gather
#: (S1), the sparse segment sum (K2) and row-wise Adagrad serve; the
#: bottom MLP; the low-rank cross stack; the top MLP
GROUPS = {"table": "tables", "bottom": "bottom", "cross": "cross",
          "top": "top", "final": "top"}


# ---------------------------------------------------------------------------
# shapes and weights
# ---------------------------------------------------------------------------

def vocabs(config: dict) -> list[int]:
    """Rows held of each field's table."""
    return list(config["num_embeddings_per_feature"])


def offsets(config: dict) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(vocabs(config))[:-1]]).astype(
        np.int64)


def bag_sizes(config: dict) -> list[int]:
    return list(config["multi_hot_sizes"])


def cross_dim(config: dict) -> int:
    return (len(vocabs(config)) + 1) * config["embedding_dim"]


def spec(config: dict) -> list:
    """(path, shape, limit) of every weight, each drawn U(−limit, limit) in
    this order: the table a field at a time at √(1/n), n the field's
    published row count (``published_num_embeddings_per_feature``);
    every linear layer's kernel and bias at 1/√fan_in
    (``torch.nn.Linear``'s default)."""
    d, out = config["embedding_dim"], []
    v = vocabs(config)
    published = config.get("published_num_embeddings_per_feature", v)
    out.append((("table",), (sum(v), d),
                [(int(lo), n, m ** -0.5)
                 for lo, n, m in zip(offsets(config), v, published)]))

    def linear(path, n_in, n_out, bias=True):
        lim = n_in ** -0.5
        return ([(path + ("w",), (n_in, n_out), lim)]
                + ([(path + ("b",), (n_out,), lim)] if bias else []))

    n_in = config["num_dense_features"]
    for i, h in enumerate(config["dense_arch_layer_sizes"]):
        out += linear(("bottom", "layers", i, "dense"), n_in, h)
        n_in = h
    dim, rank = cross_dim(config), config["dcn_low_rank_dim"]
    for i in range(config["dcn_num_layers"]):
        out += [(("cross", i, "v"), (dim, rank), dim ** -0.5)]
        out += linear(("cross", i), rank, dim)
    over = config["over_arch_layer_sizes"]
    n_in = dim
    for i, h in enumerate(over[:-1]):
        out += linear(("top", "layers", i, "dense"), n_in, h)
        n_in = h
    return out + linear(("final",), n_in, over[-1])


def make_weights(config: dict, gen: torch.Generator, device) -> dict:
    """A tree of the port's layout from `spec`, drawn on ``device``: the
    same for the same generator state."""
    tree: dict = {}
    for path, shape, limit in spec(config):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        if path == ("table",):
            for lo, n, lim in limit:
                t[lo:lo + n].uniform_(-lim, lim, generator=gen)
        else:
            t.uniform_(-limit, limit, generator=gen)
        criteo.put(tree, path, t)
    return tree


def named(norms: dict) -> dict[str, float]:
    """{group/leaf path: norm} of {leaf path: norm}, each leaf under its
    comparison group (`GROUPS`)."""
    return {f"{GROUPS[p.split('/', 1)[0]]}/{p}": v for p, v in norms.items()}


def _sq(a: torch.Tensor, b: torch.Tensor | None = None) -> float:
    """Σ (a − b)² (without ``b``, Σ a²) in float64, a block of rows at a
    time: no copy of a whole table."""
    def rows(t):
        return t.reshape(t.shape[0], -1) if t.dim() else t.reshape(1, 1)

    a, b = rows(a), None if b is None else rows(b)
    total = 0.0
    for lo in range(0, a.shape[0], BLOCK_ROWS):
        x = a[lo:lo + BLOCK_ROWS].double()
        if b is not None:
            x = x - b[lo:lo + BLOCK_ROWS].double()
        total += float(x.square().sum())
    return total


def leaf_norms(tree) -> dict[str, float]:
    """{leaf path: its float64 norm}."""
    return {criteo.path_name(p): math.sqrt(_sq(t))
            for p, t in criteo.paths(tree)}


def change_norms(after, before) -> dict[str, float]:
    """{leaf path: ‖after − before‖} in float64."""
    return {criteo.path_name(p): math.sqrt(_sq(a, b))
            for (p, a), (_, b) in zip(criteo.paths(after),
                                      criteo.paths(before), strict=True)}


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

def forward(config: dict, params: dict, rows: torch.Tensor,
            dense: torch.Tensor, mm) -> torch.Tensor:
    """Logits [B] of the gathered rows [B, S, D] (the bags side by side in
    field order) and the dense features [B, 13]."""
    b = rows.shape[0]
    h = dense
    for layer in params["bottom"]["layers"]:
        h = torch.relu(criteo.dense(layer["dense"], h, mm))
    pooled = torch.stack([part.sum(dim=1) for part in
                          rows.split(bag_sizes(config), dim=1)], dim=1)
    x0 = torch.cat([h[:, None, :], pooled], dim=1).reshape(b, -1)
    x = x0
    for layer in params["cross"]:
        x = x0 * (mm(mm(x, layer["v"]), layer["w"]) + layer["b"]) + x
    for layer in params["top"]["layers"]:
        x = torch.relu(criteo.dense(layer["dense"], x, mm))
    return criteo.dense(params["final"], x, mm)[:, 0]


# ---------------------------------------------------------------------------
# the first training steps
# ---------------------------------------------------------------------------

def batch_indices(traffic: dict, seed: int, step: int, n_rows: int,
                  device) -> torch.Tensor:
    """The rows [B] of step ``step`` as the port draws them in a run of
    ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(draws.step_seed(seed, step))
    idx = torch.empty((traffic["batch"],), dtype=torch.int64, device=device)
    return idx.random_(0, n_rows, generator=gen)


def global_ids(config: dict, ids: torch.Tensor) -> torch.Tensor:
    """[B, S] field-local ids → rows of the packed table."""
    slot = np.repeat(offsets(config), bag_sizes(config))
    return ids + torch.as_tensor(slot, device=ids.device)


def train_steps(config: dict, traffic: dict, weights: dict,
                data: dict[str, torch.Tensor], seed: int, steps: int, *,
                precision: str = "fp32", fault: str | None = None,
                keep: bool = False) -> dict:
    """Run ``steps`` training steps from ``weights`` (left unchanged) →
    {'losses': each step's loss, 'grad0': {leaf path: the norm of its first
    gradient}, 'change': {leaf path: the norm of its change over the
    steps}}; with ``keep`` also 'grad0_tree' (the first gradient, the
    table's dense [V, D]) and 'params' (the weights after the steps)."""
    if fault not in (None, "half_batch"):
        raise ValueError(f"unknown fault {fault!r}")
    mm = reference.matmul(precision)
    dtype = torch.float64 if precision == "fp64" else torch.float32
    lr, eps = config["learning_rate"], config["eps"]
    table = weights["table"].detach().to(dtype, copy=True)
    acc_table = torch.zeros(table.shape[:1], dtype=dtype, device=table.device)
    dense = {k: v for k, v in weights.items() if k != "table"}
    leaves = [p.detach().to(dtype, copy=True)
              for _, p in criteo.paths(dense)]
    accs = [torch.zeros_like(p) for p in leaves]
    n_rows = data["label"].shape[0]
    device = data["label"].device
    v, d = table.shape

    def tree(values):
        out: dict = {}
        for (path, _), leaf in zip(criteo.paths(dense), values, strict=True):
            criteo.put(out, path, leaf)
        return out

    losses, grad0, grad0_tree = [], {}, None
    for step in range(steps):
        idx = batch_indices(traffic, seed, step, n_rows, device)
        gids = global_ids(config, data["ids"][idx])
        rows = table[gids].requires_grad_()
        live = [p.requires_grad_() for p in leaves]
        logits = forward(config, tree(live), rows, data["dense"][idx].to(
            dtype), mm)
        per = reference.sigmoid_ce(logits, data["label"][idx].to(dtype))
        loss = per[:per.shape[0] // 2].mean() if fault else per.mean()
        *grads, d_rows = torch.autograd.grad(loss, live + [rows])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            leaves = [p.detach() for p in live]
            for p, g, a in zip(leaves, grads, accs):
                a.addcmul_(g, g)
                p.sub_(lr * g / (a.sqrt() + eps))
            # the table's dense gradient and its row-wise update over every
            # row, a block of rows at a time
            flat, d_flat = gids.reshape(-1), d_rows.reshape(-1, d)
            blocks, table_sq = [], 0.0
            for lo in range(0, v, BLOCK_ROWS):
                hi = min(lo + BLOCK_ROWS, v)
                sel = (flat >= lo) & (flat < hi)
                g = torch.zeros((hi - lo, d), dtype=dtype, device=device)
                g.index_add_(0, flat[sel] - lo, d_flat[sel])
                a = acc_table[lo:hi]
                a.add_((g * g).mean(dim=1))
                table[lo:hi] -= lr * g / (a.sqrt() + eps)[:, None]
                if step == 0:
                    table_sq += float(g.double().square().sum())
                    if keep:
                        blocks.append(g)
        if step == 0:
            grad0 = {"table": math.sqrt(table_sq),
                     **leaf_norms(tree(list(grads)))}
            if keep:
                grad0_tree = {"table": torch.cat(blocks),
                              **tree([g.detach() for g in grads])}
    after = {"table": table, **tree(leaves)}
    out = {"losses": losses, "grad0": grad0,
           "change": change_norms(after, weights)}
    if keep:
        out.update(grad0_tree=grad0_tree, params=after)
    return out


# ---------------------------------------------------------------------------
# work, for the readers
# ---------------------------------------------------------------------------

def forward_flops(config: dict) -> float:
    """Model flops of one example's forward pass: 2 per multiply-add of
    the bottom MLP, the cross layers (dim → rank → dim each) and the top
    MLP with its last layer. The bags' sums, the cross's elementwise work
    and the activations count none."""
    macs, n_in = 0, config["num_dense_features"]
    for h in config["dense_arch_layer_sizes"]:
        macs += n_in * h
        n_in = h
    dim, rank = cross_dim(config), config["dcn_low_rank_dim"]
    macs += config["dcn_num_layers"] * 2 * dim * rank
    n_in = dim
    for h in config["over_arch_layer_sizes"]:
        macs += n_in * h
        n_in = h
    return 2.0 * macs


def embedding_work(config: dict, traffic: dict, ids: float,
                   unique: float) -> list[tuple[float, float]]:
    """(bytes, flops) a step of the bags' three kernels, from the ids a
    step reads and the distinct rows it touches (the port's counter), each
    input read once and each output written once, ids at 8 bytes and rows
    float32:

    - the row gather (S1): the ids and the distinct rows in, every id's
      row out;
    - the sparse segment sum (K2): the ids, their int32 gradient rows and
      the pooled gradient [B, F, D] in; the distinct ids (the sentinel in
      the places past them: all ids' places), their summed rows and the
      count out;
    - row-wise Adagrad: each distinct row's id, gradient, table row and
      accumulator in, its table row and accumulator out.

    Flops: an add a gradient element in the sum; 5·D + 4 a row in the
    update (the squares' multiply-adds, and a product, a quotient and a
    difference a column). All three are bound by their bytes."""
    d = config["embedding_dim"]
    pooled = traffic["batch"] * len(vocabs(config)) * d * 4
    gather = (8 * ids + 4 * d * (unique + ids), 0.0)
    segment = (8 * ids + 4 * ids + pooled + 8 * ids + 4 * d * unique + 8,
               d * ids)
    update = (unique * (8 + 4 * d + 2 * (4 * d) + 2 * 4),
              unique * (5 * d + 4))
    return [gather, segment, update]
