"""Parameter trees between the JAX package's layout and the port's.

The trees have the same structure (nested dicts, lists, tuples and
NamedTuples such as ``AdamState(count, mu, nu)`` and ``FtrlState(z, n)``,
dense kernels ``[in, out]``, ENGINE field order everywhere) with one
exception: the JAX ``SplitEngine`` stores its big-field table transposed,
as ``tables['big_wm']`` ``[D+1, V_pad]`` (W-major, for the TPU's lane
tiling), where the port keeps it row-major as ``tables['big']``
``[V_pad, D+1]``. The rename and transpose apply wherever the key appears,
so the optimizer states, which mirror the parameter tree, follow their
parameter. The fused engine's flat ``table_flat`` and the wide model's
``wide/w`` have the same layout in both and pass through as they are.
`convert_params` maps a JAX tree of numpy arrays to port tensors;
`export_params` maps back; `convert_train_state` takes a whole JAX
``TrainState``.
"""

from __future__ import annotations

import numpy as np
import torch

from recsys_tpu_torch.core import tree as tree_util
from recsys_tpu_torch.train.train_state import TrainState, make_generator

_JAX_BIG, _PORT_BIG = "big_wm", "big"


def convert_params(tree, device="cpu"):
    """JAX-layout tree of arrays → port tree of tensors on ``device``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == _JAX_BIG:
                out[_PORT_BIG] = convert_params(np.asarray(v).T, device)
            else:
                out[k] = convert_params(v, device)
        return out
    if isinstance(tree, (list, tuple)):
        return tree_util.seq_like(tree, (convert_params(v, device)
                                         for v in tree))
    return torch.from_numpy(np.array(tree)).to(device).contiguous()


def export_params(tree):
    """Port tree of tensors → JAX-layout tree of numpy arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == _PORT_BIG:
                out[_JAX_BIG] = np.ascontiguousarray(export_params(v).T)
            else:
                out[k] = export_params(v)
        return out
    if isinstance(tree, (list, tuple)):
        return tree_util.seq_like(tree, (export_params(v) for v in tree))
    return tree.detach().cpu().numpy()


def convert_train_state(jax_ts, device="cpu"):
    """A JAX ``TrainState(params, model_state, opt_state, step, rng)`` given
    as numpy arrays (the key as its ``jax.random.key_data``) → the port's
    ``TrainState`` on ``device``. The port's root seed (and its dropout
    generator) comes from the key's bits: the two frameworks draw different
    numbers anyway."""
    params, model_state, opt_state, step, rng = jax_ts
    seed = int.from_bytes(np.asarray(rng, np.uint32).tobytes(),
                          "little") % (1 << 63)
    return TrainState(
        params=convert_params(params, device),
        model_state=convert_params(model_state, device),
        opt_state=convert_params(opt_state, device),
        step=torch.tensor(int(step), dtype=torch.int32, device=device),
        rng=make_generator(seed, device), seed=seed)
