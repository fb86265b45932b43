"""Device mesh: the port's resource model for parallelism.

Counterpart of ``ray_tpu/parallel/mesh.py``. Every parallelism strategy is a
named dimension of one ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the default process group:

    data   — data parallelism (gradients summed over it)
    fsdp   — parameter and optimizer-state sharding a la ZeRO-3 (gathered
             on use, gradients reduce-scattered)
    stage  — pipeline stages (the GPipe loop, ``parallel/pipeline.py``)
    tensor — the parameters' head and MLP dims (see ``parallel/sharding.py``)
    seq    — the sequence (ring or Ulysses attention,
             ``parallel/ring_attention.py``)
    expert — MoE experts (``parallel/moe.py``)

The reference builds a ``jax.sharding.Mesh`` over devices and lets XLA insert
the collectives; here each rank is one process, the mesh's dimensions give
the process groups, and the port's code calls the collectives itself.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("data", "fsdp", "stage", "tensor", "seq", "expert")


@dataclass(frozen=True)
class MeshConfig:
    """Declarative parallelism layout. -1 on exactly one axis = "fill with
    the remaining ranks" (like a reshape wildcard)."""

    data: int = -1
    fsdp: int = 1
    stage: int = 1
    tensor: int = 1
    seq: int = 1
    expert: int = 1

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = {a: getattr(self, a) for a in AXES}
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"only one wildcard axis allowed, got {wild}")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {fixed}"
                )
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {fixed} devices but {n_devices} available"
            )
        return sizes

    def build(self, device_type: Optional[str] = None) -> DeviceMesh:
        return make_mesh(self, device_type)


def make_mesh(config: MeshConfig,
              device_type: Optional[str] = None) -> DeviceMesh:
    """The six-axis mesh over every rank of the default process group,
    which the caller initialises (``torch.distributed.init_process_group``
    with its address, world size and rank). Ranks are laid out row-major
    over ``AXES``, so the innermost axes (tensor, seq, expert: the
    chattiest collectives) hold adjacent ranks, as the reference places
    them on ICI neighbours. ``device_type`` defaults to the default group's
    backend: "cuda" for NCCL, "cpu" for gloo."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group: call "
                           "torch.distributed.init_process_group first")
    sizes = config.resolve(dist.get_world_size())
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(sizes[a] for a in AXES),
                            mesh_dim_names=AXES)


def single_device_mesh(device_type: str = "cuda") -> DeviceMesh:
    """The world-size-1 mesh (every axis 1). Without a default process
    group it initialises one of one rank over an in-process store (NCCL
    for "cuda", gloo for "cpu"): no file and no port."""
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_world_size() != 1:
        raise ValueError(f"single_device_mesh needs a world of one rank, "
                         f"this one has {dist.get_world_size()}")
    return make_mesh(MeshConfig(data=1), device_type)


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    """The size of ``axis``; 1 without a mesh."""
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)
