"""DIN's plain reference (Zhou et al., "Deep Interest Network for
Click-Through Rate Prediction", KDD 2018, arXiv:1706.06978; widths of
wangruichens/recsys ``din/din.py:85-90``), its first training steps, its
work counts and the map of its weights into the port's parameter tree.

For a row with target item t (category c) and a history of items h_1..h_P
(categories g_1..g_P), id 0 the padding:

    e_t, e_c = item[t], cate[c];  e_j, f_j = item[h_j], cate[g_j]
    a(x_j, q) = dense_out(drop(relu(dense_2(drop(relu(dense_1(
                    [x_j, q, x_j ⊙ q, x_j − q])))))))        (80, 40 → 1)
    v_item = Σ_j a_item(e_j, e_t) · [h_j ≠ 0] · e_j
    v_cate = Σ_j a_cate(f_j, e_c) · [g_j ≠ 0] · f_j
    logit  = out(MLP([e_t, v_item, v_cate])) + bias[t]          (100-50-20)

with the MLP [dense → relu → dropout] a layer. Departures from the paper,
all the source's (and so the port's): ReLU in place of PReLU/Dice; the
attention unit's input [x, q, x⊙q, x−q] in place of [x, q, x⊗q]; the item
and category embeddings attended by two units of their own in place of one
unit over their concatenation; no batch norm; an item bias from a table of
its own; dropout in the units and the MLP; no mini-batch-aware
regularisation. The weights are the benchmark's (`spec`), drawn from the
seed.

`train_steps` is the plain training of a cell's first steps: the mean
sigmoid cross-entropy in TF's form (`reference.sigmoid_ce`), autograd's
gradients and TF's Adam, float32 with TF32 off (``precision='fp64'`` a
witness in float64, ``'tf32'`` the control: every product of a dense layer
rounded to TF32, `reference.matmul`), each step's rows and dropout masks
drawn from the port's per-step seed in the port's order (the indices, then
the item unit's two masks, the category unit's two, the MLP's three).
``fault='half_batch'`` plants a fault: the mean loss over the first half of
each batch only.

Plain PyTorch: imports nothing of the port.
"""

from __future__ import annotations

import math

import torch

from benchmark import draws, reference
from benchmark.models import criteo

#: the reference's units, by the port's top-level keys of their weights
UNITS = {"item": "att_item", "cate": "att_cate"}
#: the comparison's group of each top-level key of the port's tree: the
#: tables the row gather (S1) and the segment sum (K2) serve, the two
#: attention units, the MLP on top
GROUPS = {"item_emb": "tables", "cate_emb": "tables", "item_bias": "tables",
          "att_item": "attention", "att_cate": "attention",
          "mlp": "top", "final": "top"}


# ---------------------------------------------------------------------------
# weights of the reference's layout
# ---------------------------------------------------------------------------

def spec(config: dict) -> list:
    """(path, shape, init) of every weight: tables from a normal of TF's
    glorot_normal deviation, sqrt(2 / (V + D)), truncated at two (the
    port's own draw is untruncated), the bias table zero; dense kernels
    glorot-uniform, their biases zero."""
    d, v, vc = (config["embedding_dim"], config["item_vocab"],
                config["cate_vocab"])
    out = [(("tables", "item"), (v, d),
            ("trunc_normal", (2.0 / (v + d)) ** 0.5)),
           (("tables", "cate"), (vc, d),
            ("trunc_normal", (2.0 / (vc + d)) ** 0.5)),
           (("tables", "bias"), (v,), ("zeros",))]
    for unit in UNITS:
        n_in = 4 * d
        for i, h in enumerate(config["attention_layers"]):
            out += criteo.dense_spec(("units", unit, "hidden", i), n_in, h)
            n_in = h
        out += criteo.dense_spec(("units", unit, "out"), n_in, 1)
    n_in = 3 * d
    for i, h in enumerate(config["mlp_layers"]):
        out += criteo.dense_spec(("mlp", i), n_in, h)
        n_in = h
    return out + criteo.dense_spec(("out",), n_in, 1)


# ---------------------------------------------------------------------------
# the port's layout
# ---------------------------------------------------------------------------

def _port_path(path: tuple) -> tuple:
    """The port's path of a leaf of the reference's layout."""
    if path[0] == "tables":
        return ({"item": "item_emb", "cate": "cate_emb",
                 "bias": "item_bias"}[path[1]],)
    if path[0] == "units":
        top = UNITS[path[1]]
        if path[2] == "hidden":
            return (top, "mlp", path[3], path[4])
        return (top, "out", path[3])
    if path[0] == "mlp":
        return ("mlp", "layers", path[1], "dense", path[2])
    return ("final", path[1])


def pack(config: dict, canon: dict, template) -> dict:
    """A tree shaped as the port's parameter tree ``template`` (tensors on
    the 'meta' device give the shapes), filled from the reference-layout
    tree ``canon`` (weights, gradients or changes of them): new tensors,
    none of which shares storage with ``canon``."""
    del config
    out: dict = {}
    for path, value in criteo.paths(canon):
        port = _port_path(path)
        leaf = criteo.get(template, port)
        if tuple(value.shape) != tuple(leaf.shape):
            raise ValueError(f"pack: {criteo.path_name(path)} is "
                             f"{tuple(value.shape)}, the port's "
                             f"{criteo.path_name(port)} is "
                             f"{tuple(leaf.shape)}")
        criteo.put(out, port, value.clone(
            memory_format=torch.contiguous_format))
    missing = ({criteo.path_name(p) for p, _ in criteo.paths(template)}
               - {criteo.path_name(p) for p, _ in criteo.paths(out)})
    if missing:
        raise ValueError(f"pack: the port's tree holds {sorted(missing)}, "
                         "which the reference has not")
    return out


def leaf_norms(tree) -> dict[str, float]:
    """{group/leaf path: its float64 norm} of a tree of the port's layout,
    each leaf under its comparison group (`GROUPS`), so that
    ``compare.gaps`` reads the worst leaf of each group."""
    return {f"{GROUPS[p[0]]}/{criteo.path_name(p)}":
            float(t.detach().double().norm())
            for p, t in criteo.paths(tree)}


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

def _dropped(h: torch.Tensor, mask: torch.Tensor, keep: float):
    return torch.where(mask, h / keep, torch.zeros_like(h))


def attention(config: dict, unit: dict, hist: torch.Tensor,
              hist_ids: torch.Tensor, query: torch.Tensor, masks, mm):
    """One unit → [B, D]: hist [B, P, D], hist_ids [B, P], query [B, D],
    ``masks`` the two hidden layers' dropout masks [B·P, h] (True keeps)."""
    b, p, d = hist.shape
    q = query[:, None, :].expand(b, p, d)
    h = torch.cat([hist, q, hist * q, hist - q], dim=2).reshape(b * p, 4 * d)
    keep = 1.0 - config["dropout"]
    for layer, mask in zip(unit["hidden"], masks, strict=True):
        h = _dropped(torch.relu(criteo.dense(layer, h, mm)), mask, keep)
    weight = criteo.dense(unit["out"], h, mm).reshape(b, p, 1)
    real = (hist_ids != 0).to(hist.dtype)[:, :, None]
    return (weight * real * hist).sum(dim=1)


def forward(config: dict, params: dict, batch: dict, masks: list,
            mm) -> torch.Tensor:
    """Train-mode logits [B] with the dropout masks given (the item
    unit's two, the category unit's two, the MLP's, in that order)."""
    t = params["tables"]
    e_t, e_c = t["item"][batch["i_id"]], t["cate"][batch["i_cate"]]
    n_att = len(config["attention_layers"])
    v_item = attention(config, params["units"]["item"],
                       t["item"][batch["hist_iid"]], batch["hist_iid"], e_t,
                       masks[:n_att], mm)
    v_cate = attention(config, params["units"]["cate"],
                       t["cate"][batch["hist_cate"]], batch["hist_cate"],
                       e_c, masks[n_att:2 * n_att], mm)
    h = torch.cat([e_t, v_item, v_cate], dim=1)
    keep = 1.0 - config["dropout"]
    for layer, mask in zip(params["mlp"], masks[2 * n_att:], strict=True):
        h = _dropped(torch.relu(criteo.dense(layer, h, mm)), mask, keep)
    return criteo.dense(params["out"], h, mm)[:, 0] + t["bias"][batch["i_id"]]


# ---------------------------------------------------------------------------
# the first training steps
# ---------------------------------------------------------------------------

def batch_draws(config: dict, traffic: dict, seed: int, step: int,
                n_rows: int, device):
    """(indices [B], dropout masks) of step ``step`` as the port draws them
    in a run of ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(draws.step_seed(seed, step))
    b, p = traffic["batch"], config["max_hist"]
    idx = torch.empty((b,), dtype=torch.int64, device=device)
    idx.random_(0, n_rows, generator=gen)
    keep = 1.0 - config["dropout"]
    shapes = ([(b * p, h) for h in config["attention_layers"]] * len(UNITS)
              + [(b, h) for h in config["mlp_layers"]])
    masks = [torch.rand(s, generator=gen, device=device) < keep
             for s in shapes]
    return idx, masks


def train_steps(config: dict, traffic: dict, weights: dict,
                data: dict[str, torch.Tensor], seed: int, steps: int, *,
                precision: str = "fp32", fault: str | None = None) -> dict:
    """Run ``steps`` training steps from ``weights`` (a tree of the
    reference's layout, left unchanged) → {'losses': [each step's loss],
    'grad0': the first step's gradient tree, 'params': the weights after
    the steps}."""
    if fault not in (None, "half_batch"):
        raise ValueError(f"unknown fault {fault!r}")
    mm = reference.matmul(precision)
    dtype = torch.float64 if precision == "fp64" else torch.float32
    opt = config["optimizer"]
    b1, b2, eps, lr = opt["b1"], opt["b2"], opt["eps"], opt["learning_rate"]
    params = [p.detach().to(dtype, copy=True)
              for _, p in criteo.paths(weights)]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    n_rows = data["label"].shape[0]
    device = data["label"].device

    def tree(leaves):
        out: dict = {}
        for (path, _), leaf in zip(criteo.paths(weights), leaves,
                                   strict=True):
            criteo.put(out, path, leaf)
        return out

    losses, grad0 = [], None
    for step in range(steps):
        idx, masks = batch_draws(config, traffic, seed, step, n_rows, device)
        batch = {k: v[idx] for k, v in data.items()}
        live = [p.requires_grad_() for p in params]
        logits = forward(config, tree(live), batch, masks, mm)
        per = reference.sigmoid_ce(logits, batch["label"].to(dtype))
        loss = per[:per.shape[0] // 2].mean() if fault else per.mean()
        grads = torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True)
        losses.append(float(loss.detach()))
        if step == 0:
            grad0 = tree([g.detach() for g in grads])
        t = step + 1
        lr_t = lr * math.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
        with torch.no_grad():
            params = [p.detach() for p in live]
            for p, g, m, v in zip(params, grads, mu, nu):
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                p.sub_(lr_t * m / (v.sqrt() + eps))
    return {"losses": losses, "grad0": grad0, "params": tree(params)}


# ---------------------------------------------------------------------------
# work, for the readers
# ---------------------------------------------------------------------------

def _unit_macs(config: dict) -> int:
    """Multiply-adds of one attention unit's dense layers at one history
    position."""
    macs, n_in = 0, 4 * config["embedding_dim"]
    for h in config["attention_layers"]:
        macs += n_in * h
        n_in = h
    return macs + n_in


def forward_flops(config: dict) -> float:
    """Model flops of one example's forward pass at a history of
    ``max_hist`` positions: 2 per multiply-add of the dense layers, the two
    attention units' at every position (padded or not: the port computes
    them all) and the MLP's. The elementwise work (the units' input, the
    masked sum, the activations) and the lookups count none."""
    macs, n_in = 0, 3 * config["embedding_dim"]
    for h in config["mlp_layers"]:
        macs += n_in * h
        n_in = h
    return 2.0 * (len(UNITS) * config["max_hist"] * _unit_macs(config)
                  + macs + n_in)


def attention_work(config: dict, traffic: dict) -> tuple[float, float]:
    """(bytes, flops) of a training step's two attention units, forward and
    backward together: flops 3 × the dense layers' forward (the backward
    twice it) at every one of the B·P positions; bytes the least they must
    move, each input read once and each output written once, in float32
    with 8-byte ids: the history's rows [B, P, D] and ids [B, P] and the
    query [B, D] in, the result [B, D] out, and back the result's gradient
    in and the gradients of the rows and of the query out, and each unit's
    weights read and their gradients written."""
    d, b, p = config["embedding_dim"], traffic["batch"], config["max_hist"]
    weights, n_in = 0, 4 * d
    for h in config["attention_layers"] + [1]:
        weights += n_in * h + h
        n_in = h
    flops = 3.0 * 2.0 * b * p * _unit_macs(config)
    per_unit = (4 * (2 * b * p * d + 4 * b * d + 2 * weights)
                + 8 * b * p)
    return (len(UNITS) * per_unit, len(UNITS) * flops)


def kernel_work(config: dict, traffic: dict) -> dict:
    """(bytes, flops) a step of each family the readers time."""
    return {"attention": [attention_work(config, traffic)]}
