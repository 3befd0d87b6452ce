"""The device mesh over ``torch.distributed`` ranks (port of pgica_tpu/parallel/mesh.py).

The JAX package names five mesh axes, ``("dcn", "data", "fsdp", "model",
"seq")``, over the devices of one program. Here every rank is one process
with one device, and rank ``r`` has the coordinates of ``devices[r]`` in the
JAX package's ``reshape(dcn, data, fsdp, model, seq)``: row-major, ``seq``
fastest. ``MeshContext`` keeps one process group per axis longer than 1 and
one for the batch axes ``("dcn", "data", "fsdp")``, over which a batch is
split (``shard_batch``: the contiguous block of rows at this rank's index,
as ``NamedSharding(P(("dcn", "data", "fsdp")))`` splits it), and one for the
batch axes with ``seq`` (context parallelism sums its gradients over them).
The ranks of one batch block along ``model`` and ``seq`` see the same rows.

``with mesh:`` binds the axis names for the collectives of
``parallel/collectives.py``, as ``shard_map`` binds them in the JAX package.

``init_distributed()`` takes a process group that is already initialized,
or initializes one from ``RANK``/``WORLD_SIZE`` (``torchrun`` sets them,
with ``MASTER_ADDR``/``MASTER_PORT``): NCCL for a ``cuda`` device, gloo for
the CPU.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

AXES = ("dcn", "data", "fsdp", "model", "seq")
BATCH_AXES = ("dcn", "data", "fsdp")
AxisName = Union[str, Tuple[str, ...]]

_ACTIVE: list = []  # the meshes entered with ``with``, innermost last


def init_distributed(device: Union[str, torch.device] = "cuda") -> Tuple[int, int]:
    """(rank, world size): the initialized process group's, else one started from the environment.

    Without ``WORLD_SIZE`` in the environment and no group, a single process: (0, 1).
    """
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if "WORLD_SIZE" not in os.environ:
        return 0, 1
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, device_id=device if device.type == "cuda" else None)
    dist.barrier()  # every rank is up (NCCL makes its communicator here)
    rank, world = dist.get_rank(), dist.get_world_size()
    logger.info("Process group %s: rank %d of %d", backend, rank, world)
    return rank, world


def active_mesh() -> Optional["MeshContext"]:
    return _ACTIVE[-1] if _ACTIVE else None


def axis_names(axis: AxisName) -> Tuple[str, ...]:
    names = axis if isinstance(axis, tuple) else (axis,)
    unknown = [a for a in names if a not in AXES]
    if unknown:
        raise ValueError(f"unknown mesh axis {unknown}; the axes are {AXES}")
    return tuple(a for a in AXES if a in names)  # mesh order: the order of the ranks in a group


class MeshContext:
    """The ranks' mesh: its shape, this rank's coordinates, one process group per axis."""

    def __init__(
        self,
        data: int = -1,
        fsdp: int = 1,
        model: int = 1,
        dcn: int = 1,
        seq: int = 1,
        world_size: Optional[int] = None,
        rank: Optional[int] = None,
    ):
        initialized = dist.is_available() and dist.is_initialized()
        n = world_size if world_size is not None else (dist.get_world_size() if initialized else 1)
        if data == -1:
            if n % (dcn * fsdp * model * seq) != 0:
                raise ValueError(
                    f"{n} devices not divisible by dcn*fsdp*model*seq={dcn * fsdp * model * seq}"
                )
            data = n // (dcn * fsdp * model * seq)
        if dcn * data * fsdp * model * seq != n:
            raise ValueError(f"Mesh {dcn}x{data}x{fsdp}x{model}x{seq} does not match {n} devices")
        self.shape: Dict[str, int] = dict(zip(AXES, (dcn, data, fsdp, model, seq)))
        self.rank = rank if rank is not None else (dist.get_rank() if initialized else 0)
        self.coords: Dict[str, int] = dict(zip(AXES, (int(c) for c in np.unravel_index(self.rank, tuple(self.shape.values())))))
        self._groups: Dict[Tuple[str, ...], object] = {}
        self.distributed = initialized and n > 1
        if self.distributed:
            for axis in [(a,) for a in AXES] + [BATCH_AXES, ("data", "fsdp"), BATCH_AXES + ("seq",), ("dcn", "data"),
                                                ("dcn", "data", "seq"), ("fsdp", "model")]:
                self.group(axis)  # every rank creates every group, in one order
        logger.info("Mesh created: %s over %d ranks (this rank %d at %s)", self.shape, n, self.rank, self.coords)

    @classmethod
    def from_config(cls, config, world_size: Optional[int] = None, rank: Optional[int] = None) -> "MeshContext":
        return cls(
            data=config.get("mesh.data", -1),
            fsdp=config.get("mesh.fsdp", 1),
            model=config.get("mesh.model", 1),
            dcn=config.get("mesh.dcn", 1),
            seq=config.get("mesh.seq", 1),
            world_size=world_size,
            rank=rank,
        )

    @property
    def num_devices(self) -> int:
        return int(np.prod(list(self.shape.values())))

    @property
    def data_parallel_size(self) -> int:
        return self.shape["dcn"] * self.shape["data"] * self.shape["fsdp"]

    # -- axes ---------------------------------------------------------------

    def axis_size(self, axis: AxisName) -> int:
        return int(np.prod([self.shape[a] for a in axis_names(axis)]))

    def axis_index(self, axis: AxisName) -> int:
        """This rank's index along ``axis`` (a tuple: row-major over its axes, as JAX's ``axis_index``)."""
        index = 0
        for a in axis_names(axis):
            index = index * self.shape[a] + self.coords[a]
        return index

    def group(self, axis: AxisName):
        """The process group of this rank's ``axis``; None where the axis has one rank."""
        names = axis_names(axis)
        if self.axis_size(names) == 1:
            return None
        if not self.distributed:
            raise RuntimeError(f"mesh axis {names} spans {self.axis_size(names)} ranks, but no process group "
                               "is initialized")
        if names not in self._groups:
            grid = np.arange(self.num_devices).reshape(tuple(self.shape.values()))
            moved = np.moveaxis(grid, [AXES.index(a) for a in names], list(range(-len(names), 0)))
            subgroups = [[int(r) for r in row] for row in moved.reshape(-1, self.axis_size(names))]
            if len(subgroups) == 1:
                self._groups[names] = dist.group.WORLD
            else:
                self._groups[names], _ = dist.new_subgroups_by_enumeration(subgroups)
        return self._groups[names]

    # -- batches ------------------------------------------------------------

    @property
    def batch_index(self) -> int:
        return self.axis_index(BATCH_AXES)

    def shard_batch(self, batch: Mapping[str, object]) -> Dict[str, object]:
        """This rank's rows of a global batch: the block at its batch-axis index.

        A batch whose rows the batch axes do not divide raises, as the JAX
        package's ``device_put`` onto the batch sharding does.
        """
        n, i = self.data_parallel_size, self.batch_index
        out = {}
        for key, value in batch.items():
            rows = len(value)
            if rows % n:
                raise ValueError(
                    f"batch {key!r} of {rows} rows: its dimension 0 should be divisible by the "
                    f"{n} ranks of the batch axes {BATCH_AXES}"
                )
            out[key] = value[i * rows // n:(i + 1) * rows // n]
        return out

    def barrier(self) -> None:
        """Wait for every rank (a no-op on one rank)."""
        if self.distributed:
            dist.barrier()

    def __enter__(self):
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return False
