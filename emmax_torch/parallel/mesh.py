"""Device mesh construction, port of ``emmax_tpu/parallel/mesh.py``.

A ``torch.distributed.device_mesh.DeviceMesh`` over every rank of the
default process group, with the JAX package's named axes:

- ``replica``: pure data parallel (the reference's HYBRID_SHARD replica
  group);
- ``fsdp``: the fully-sharded parameter axis (FULL_SHARD / SHARD_GRAD_OP);
- ``tensor``: the tensor-parallel axis of the JAX package's rules.

``-1`` in a shape takes every remaining device. One process drives one
device, so the mesh's size is the world size.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

AXIS_NAMES = ("replica", "fsdp", "tensor")


def resolve_mesh_shape(shape: Sequence[int],
                       n_devices: int) -> Tuple[int, ...]:
    """``shape`` with its one ``-1`` filled so the product is
    ``n_devices``; raises ValueError when it cannot be."""
    shape = list(shape)
    known = math.prod(s for s in shape if s != -1)
    if -1 in shape:
        if shape.count(-1) != 1:
            raise ValueError(f"at most one -1 axis: {shape}")
        if n_devices % known:
            raise ValueError(f"mesh {shape} does not divide {n_devices} "
                             "devices")
        shape[shape.index(-1)] = n_devices // known
    if math.prod(shape) != n_devices:
        raise ValueError(f"mesh {shape} != {n_devices} devices")
    return tuple(shape)


def make_mesh(shape: Sequence[int] = (1, -1, 1), device_type: str = "cuda",
              axis_names: Sequence[str] = AXIS_NAMES):
    """The ``(replica, fsdp, tensor)`` DeviceMesh over the initialized
    process group (``parallel.distributed.initialize_distributed``), on
    ``device_type`` ("cuda" unless the caller asks for "cpu")."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group: "
                           "call parallel.initialize_distributed() first")
    resolved = resolve_mesh_shape(shape, dist.get_world_size())
    return init_device_mesh(device_type, resolved,
                            mesh_dim_names=tuple(axis_names))


def strategy_to_mesh_shape(train_strategy: str, n_devices: int,
                           n_hosts: int = 1) -> Tuple[int, int, int]:
    """The reference's ``train_strategy`` names as mesh shapes:
    full-shard puts every device on ``fsdp``; shard-grad-op (ZeRO-2
    hybrid) shards within a host and replicates across hosts; ddp is pure
    ``replica``."""
    if train_strategy in ("fsdp-full-shard", "fsdp"):
        return (1, n_devices, 1)
    if train_strategy == "fsdp-shard-grad-op":
        per = max(n_devices // max(n_hosts, 1), 1)
        return (n_devices // per, per, 1)
    if train_strategy == "ddp":
        return (n_devices, 1, 1)
    raise ValueError(f"unknown train strategy {train_strategy!r}")
