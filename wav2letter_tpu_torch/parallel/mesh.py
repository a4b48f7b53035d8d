"""The grid of ranks — the port of ``wav2letter_tpu/parallel/mesh.py``.

The JAX package lays its devices out as a ``(data, model)`` mesh, row-major
(``np.array(devices).reshape(n_data, n_model)``). Here each rank drives one
device, so rank ``r`` sits at data index ``r // n_model`` and model index
``r % n_model`` (:func:`mesh_coords`). The ranks of one model index form a
data group, over which gradients and meters are summed; the ranks of one data
index form a model group, which holds the shards of the tensor-parallel
weights and the same rows of every batch.
"""

from __future__ import annotations

import dataclasses
from datetime import timedelta
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .distributed import GROUP_TIMEOUT, world_size

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass
class MeshSpec:
    n_data: int
    n_model: int = 1

    @classmethod
    def from_config(cls, cfg, n_devices: Optional[int] = None) -> "MeshSpec":
        """``--dp_axis`` ranks on the data axis, or all of them over
        ``--mp_axis`` when it is <= 0. Never fewer than one: a model axis
        wider than the world then fails in :func:`make_mesh`, as in JAX."""
        n = n_devices if n_devices is not None else world_size()
        mp = max(1, cfg.mp_axis)
        dp = cfg.dp_axis if cfg.dp_axis > 0 else max(1, n // mp)
        return cls(dp, mp)


def mesh_coords(rank: int, spec: MeshSpec) -> Tuple[int, int]:
    """(data index, model index) of ``rank``: its place in JAX's row-major
    device grid."""
    return rank // spec.n_model, rank % spec.n_model


@dataclasses.dataclass
class Mesh:
    """This rank's place in the grid, its device and its two groups. Without
    a process group (one process) both groups are None and nothing is
    communicated."""

    spec: MeshSpec
    device: torch.device = torch.device("cpu")
    rank: int = 0
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def data_index(self) -> int:
        return mesh_coords(self.rank, self.spec)[0]

    @property
    def model_index(self) -> int:
        return mesh_coords(self.rank, self.spec)[1]

    @property
    def distributed(self) -> bool:
        return self.data_group is not None


def make_mesh(spec: Optional[MeshSpec] = None, device: torch.device = torch.device("cpu"),
              timeout: timedelta = GROUP_TIMEOUT) -> Mesh:
    """The mesh of the current process group (every rank must call it: the
    groups are made collectively), or of one process when there is none.
    ``device`` is the rank's one device, where its collectives' tensors live."""
    n = world_size()
    if spec is None:
        spec = MeshSpec(n, 1)
    need = spec.n_data * spec.n_model
    if need > n:
        raise ValueError(f"mesh {spec} needs {need} devices, have {n}")
    if need < n:
        # JAX leaves the surplus devices idle; a rank here would hold no rows
        raise ValueError(f"mesh {spec} places {need} of the {n} ranks")
    device = torch.device(device)
    if not dist.is_initialized():
        return Mesh(spec, device)
    rank = dist.get_rank()
    mine = mesh_coords(rank, spec)
    data_group = model_group = None
    for j in range(spec.n_model):
        g = dist.new_group([i * spec.n_model + j for i in range(spec.n_data)], timeout=timeout)
        if j == mine[1]:
            data_group = g
    for i in range(spec.n_data):
        g = dist.new_group([i * spec.n_model + j for j in range(spec.n_model)], timeout=timeout)
        if i == mine[0]:
            model_group = g
    return Mesh(spec, device, rank, data_group, model_group)


# The training mesh, published by the Trainer so that mesh-aware layers (the
# fused attention's head split) find it without threading it through every
# module signature, as in the JAX package.
_CURRENT_MESH: Optional[Mesh] = None


def set_current_mesh(mesh: Optional[Mesh]) -> None:
    global _CURRENT_MESH
    _CURRENT_MESH = mesh


def current_mesh() -> Optional[Mesh]:
    return _CURRENT_MESH
