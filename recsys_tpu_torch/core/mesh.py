"""The device mesh over ``torch.distributed`` (counterpart of
``recsys_tpu/core/mesh.py``): one process per device, and the world's ranks
laid out as a 2-D ``('data', 'model')`` mesh.

- ``data``: the batch is split over it (pure data parallelism for the dense
  towers; their gradients are summed over it).
- ``model``: the embedding tables' rows are split over it (the lookups
  exchange ids and rows over it, ``parallel/sharded_embedding.py``).

The JAX mesh is ``devices.reshape(data, model)``, so rank ``r`` sits at
``(d, m) = divmod(r, model)``: the model group of a rank holds the ranks
of its ``d``, its data group the ranks of its ``m``. Ranks of one ``d`` see
the same batch rows.

`distributed_init` starts the process group: NCCL on ``cuda:LOCAL_RANK``
unless the caller asks for the CPU, which gives gloo. It never falls back
to the CPU by itself.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from recsys_tpu_torch.core.config import MeshConfig
from recsys_tpu_torch.parallel.collectives import Axis

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class MeshEnv:
    """This rank's view of the mesh: its coordinates, its two axes' groups,
    and the device its tensors live on."""

    num_data: int
    num_model: int
    rank: int
    device: torch.device
    data: Axis      # the ranks of this rank's m; index = d
    model: Axis     # the ranks of this rank's d; index = m

    @property
    def d(self) -> int:
        return self.data.index

    @property
    def m(self) -> int:
        return self.model.index

    @property
    def world(self) -> int:
        return self.num_data * self.num_model


def distributed_init(init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None, *, cpu: bool = False,
                     timeout_s: float = 600.0) -> torch.device:
    """Join the process group and return this rank's device.

    With no arguments it reads torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``);
    ``init_method`` (``file://…`` or ``tcp://host:port``), ``world_size``
    and ``rank`` override it. The backend is NCCL on ``cuda:LOCAL_RANK``,
    or gloo on the CPU when ``cpu`` is true; without a card and without
    ``cpu`` it raises. Every collective waits at most ``timeout_s``."""
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    if cpu:
        backend, device = "gloo", torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("distributed_init: no CUDA device is "
                               "available (pass cpu=True for gloo on the "
                               "CPU)")
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = "nccl"
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            world_size=world_size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
    elif dist.get_backend() != backend:
        raise RuntimeError(f"distributed_init: the process group runs "
                           f"{dist.get_backend()}, not {backend}")
    return device


def make_mesh(cfg: MeshConfig = MeshConfig(),
              device: torch.device | None = None) -> MeshEnv:
    """The ``(data, model)`` mesh over the initialized world. Every rank
    calls it at once (it creates the axes' process groups). ``device`` is
    the rank's device: by default ``cuda`` (the current one) under NCCL,
    the CPU under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call distributed_init first")
    n, rank = dist.get_world_size(), dist.get_rank()
    model = max(1, cfg.model_axis)
    data = cfg.data_axis if cfg.data_axis > 0 else n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} does not cover {n} devices")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    d, m = divmod(rank, model)
    # every rank creates every group, in the same order
    model_groups = [dist.new_group([i * model + j for j in range(model)])
                    for i in range(data)]
    data_groups = [dist.new_group([i * model + j for i in range(data)])
                   for j in range(model)]
    return MeshEnv(num_data=data, num_model=model, rank=rank, device=device,
                   data=Axis(data_groups[m], data, d),
                   model=Axis(model_groups[d], model, m))


def host_shard_of(files: list, process_index: int | None = None,
                  process_count: int | None = None) -> list:
    """Per-process file-shard assignment: process i takes files i, i+P,
    i+2P, … (by default this rank of the world)."""
    if process_index is None:
        process_index = dist.get_rank() if dist.is_initialized() else 0
    if process_count is None:
        process_count = (dist.get_world_size() if dist.is_initialized()
                         else 1)
    return files[process_index::process_count]
