"""Parameter trees between the JAX package's layout and the port's.

The trees have the same structure (nested dicts and lists, dense kernels
``[in, out]``, ENGINE field order everywhere) with one exception: the JAX
``SplitEngine`` stores its big-field table transposed, as
``tables['big_wm']`` ``[D+1, V_pad]`` (W-major, for the TPU's lane
tiling), where the port keeps it row-major as ``tables['big']``
``[V_pad, D+1]``. `convert_params` maps a JAX tree of numpy arrays to port
tensors; `export_params` maps back.
"""

from __future__ import annotations

import numpy as np
import torch

_JAX_BIG, _PORT_BIG = "big_wm", "big"


def convert_params(tree, device="cpu"):
    """JAX-layout tree of arrays → port tree of float tensors on
    ``device``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == _JAX_BIG:
                out[_PORT_BIG] = convert_params(np.asarray(v).T, device)
            else:
                out[k] = convert_params(v, device)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(convert_params(v, device) for v in tree)
    return torch.from_numpy(np.asarray(tree)).to(device).contiguous()


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
        return type(tree)(export_params(v) for v in tree)
    return tree.detach().cpu().numpy()
