"""The device mesh (ported from progen_tpu/core/mesh.py) on
``torch.distributed``: one process per GPU, and a ``DeviceMesh`` over the
ranks with four named dims

    ('data', 'fsdp', 'tensor', 'seq')

* ``data`` -- data parallelism (batch split, parameters replicated);
* ``fsdp`` -- batch split and parameters sharded (FSDP2, ZeRO-3 style);
* ``tensor`` -- tensor parallelism (megatron-style): the heads and mlp
  channels split over ranks (``parallel/tensor.py``);
* ``seq`` -- sequence (context) parallelism: activations split along L, the
  windowed attention's halo and the SGU's gather (``parallel/context.py``).

Sizes multiply to the world size; unused dims have size 1.  The innermost
dims (``seq``) vary fastest over the ranks, as JAX lays them out.
"""

from __future__ import annotations

import dataclasses
import math
import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

MESH_AXES = ("data", "fsdp", "tensor", "seq")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes for each logical mesh axis. ``-1`` on one axis means "absorb the
    remaining ranks" (like a reshape wildcard)."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1

    @classmethod
    def parse(cls, spec: str) -> "MeshConfig":
        """Parse a CLI mesh spec ``"data,fsdp,tensor,seq"`` (e.g.
        ``"-1,1,1,1"``; ``-1`` = absorb remaining ranks)."""
        parts = spec.split(",")
        if len(parts) != 4:
            raise ValueError(
                f"mesh spec {spec!r} must have exactly 4 comma-separated "
                "sizes: data,fsdp,tensor,seq (e.g. '-1,1,1,1')")
        try:
            sizes = [int(p) for p in parts]
        except ValueError as e:
            raise ValueError(
                f"mesh spec {spec!r}: every size must be an integer "
                "(data,fsdp,tensor,seq)") from e
        return cls(*sizes)

    def resolve(self, n_devices: int) -> tuple[int, int, int, int]:
        sizes = [self.data, self.fsdp, self.tensor, self.seq]
        wild = [i for i, s in enumerate(sizes) if s == -1]
        if len(wild) > 1:
            raise ValueError("at most one mesh axis may be -1")
        fixed = math.prod(s for s in sizes if s != -1)
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(f"mesh {sizes} needs {fixed} devices, have {n_devices}")
        return tuple(sizes)


def auto_factorize(n_devices: int, *, use_fsdp: bool = True,
                   use_tp: bool = True, use_sp: bool = True) -> MeshConfig:
    """Factor ``n_devices`` onto ``(data, fsdp, tensor, seq)`` innermost
    first: each enabled inner axis (seq, then tensor, then fsdp) absorbs one
    factor of 2 while the remainder stays even; whatever is left becomes the
    data axis."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    sizes = {"seq": 1, "tensor": 1, "fsdp": 1}
    rem = n_devices
    for axis, enabled in (("seq", use_sp), ("tensor", use_tp),
                          ("fsdp", use_fsdp)):
        if enabled and rem % 2 == 0 and rem > 1:
            sizes[axis] = 2
            rem //= 2
    return MeshConfig(data=rem, fsdp=sizes["fsdp"], tensor=sizes["tensor"],
                      seq=sizes["seq"])


def process_batch_shards(mesh, me: int | None = None) -> tuple[int, int]:
    """``(shard_count, shard_index)`` of process ``me`` (default: this rank)
    over the batch, which shards over ``('data', 'fsdp')`` only.

    ``mesh`` is a ``DeviceMesh`` (its rank grid; one GPU per process, so a
    rank is a process) or any ``(data, fsdp, tensor, seq)`` grid of process
    ids.  Processes at the same batch coordinates (the members of a ``seq``
    group) load identical rows; processes at different ones load disjoint
    shards.  Raises when a process straddles batch coordinates that other
    processes do not share exactly."""
    grid = np.asarray(mesh.mesh if isinstance(mesh, DeviceMesh) else mesh)
    n_fsdp = grid.shape[1]
    coverage: dict[int, set[int]] = {}
    for idx in np.ndindex(*grid.shape):
        coverage.setdefault(int(grid[idx]), set()).add(idx[0] * n_fsdp + idx[1])
    me = dist.get_rank() if me is None else me
    if me not in coverage:
        raise ValueError(f"process {me} owns no devices in mesh {grid.shape}")
    groups = sorted({frozenset(s) for s in coverage.values()}, key=min)
    claimed: set[int] = set()
    for g in groups:
        if claimed & g:
            raise ValueError(
                "mesh layout shards the batch axis inconsistently across "
                f"processes (coverage sets {sorted(map(sorted, groups))}); "
                "keep each process's devices at one contiguous (data, fsdp) block")
        claimed |= g
    return len(groups), groups.index(frozenset(coverage[me]))


def mesh_sizes(mesh: DeviceMesh) -> dict[str, int]:
    """``{axis: size}`` of a four-axis mesh, JAX's ``mesh.shape``."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def make_mesh(config: MeshConfig | None = None,
              device_type: str | None = None) -> DeviceMesh:
    """The four-axis ``DeviceMesh`` over every rank of the default process
    group (:func:`initialize_distributed` first).  ``device_type`` defaults
    to the process group's: ``cuda`` under NCCL, ``cpu`` under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "initialize_distributed() first")
    config = config or MeshConfig()
    sizes = config.resolve(dist.get_world_size())
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, sizes, mesh_dim_names=MESH_AXES)


def single_device_mesh(device_type: str | None = None) -> DeviceMesh:
    """A 1x1x1x1 mesh: every code path mesh-driven on one rank (a process
    group of one)."""
    if not dist.is_initialized():
        raise RuntimeError("single_device_mesh needs a process group: call "
                           "initialize_distributed() first")
    if dist.get_world_size() != 1:
        raise ValueError(f"a single-device mesh needs world size 1, have "
                         f"{dist.get_world_size()}")
    return make_mesh(MeshConfig(1, 1, 1, 1), device_type)


def initialize_distributed(device: str | torch.device = "cuda",
                           init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None) -> None:
    """Start the default process group once per process: NCCL on the card,
    gloo when ``device`` is the CPU.

    ``world_size`` and ``rank`` default to ``WORLD_SIZE`` and ``RANK`` in the
    environment (``torchrun`` sets them, with ``MASTER_ADDR``/``MASTER_PORT``
    for ``env://``, the default ``init_method`` of more than one rank); a
    ``tcp://host:port`` or ``file://`` ``init_method`` takes ranks started by
    hand.  A world of one with no ``init_method`` meets in memory.  On the
    card each rank takes the GPU of its local rank."""
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    world_size = 1 if world_size is None else world_size
    rank = 0 if rank is None else rank
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' for a gloo group")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    timeout = timedelta(seconds=600)  # a rank that waits longer has lost its peers
    if init_method is None and world_size == 1:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0,
                                timeout=timeout)
        return
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, timeout=timeout)
