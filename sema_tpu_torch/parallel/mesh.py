"""Device meshes of the port (from ``sema_tpu/parallel/mesh.py``).

The JAX package's mesh is single-controller: one process drives every
device of a ``jax.sharding.Mesh``. The port keeps that model: a
:class:`Mesh` is an ndarray of ``torch.device`` with named axes, and one
process runs every shard's work on its device, in shard order. NCCL takes
one rank per card, so ``torch.distributed`` cannot put two shards on one
card; here a device may repeat, the counterpart of JAX's virtual CPU
devices, so a single card or the CPU can hold several shards, each doing
the work of a shard at its real local width. A mesh over distinct cards
runs the same code.

Axes, as in the JAX package: ``data`` splits the encoder's batch,
``model`` shards the encoder's weights (tensor parallelism), ``index``
shards the store's rows (each shard scans its block, and the candidates
merge: :mod:`sema_tpu_torch.parallel.sharded_topk`), and ``slice``, where
a mesh has it, shards them too, slice-major, with a two-level merge
(:mod:`sema_tpu_torch.parallel.multislice`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
INDEX_AXIS = "index"


class Mesh:
    """``devices``, an ndarray of ``torch.device``, with one name per
    axis; ``shape`` maps each name to its size, as JAX's does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes "
                             f"{tuple(axis_names)}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def grid(self, leading: Sequence[str], values: Optional[np.ndarray] = None
             ) -> np.ndarray:
        """``values`` (an ndarray of the mesh's shape, by default its
        devices) with the axes ``leading`` first, in that order, and every
        other axis cut to its first entry: the work of a shard along those
        axes repeats along the others, so one copy of it is the result."""
        arr = self.devices if values is None else values
        order = [self.axis_names.index(a) for a in leading]
        rest = [i for i in range(len(self.axis_names)) if i not in order]
        arr = arr.transpose(order + rest)
        return arr[(Ellipsis,) + (0,) * len(rest)] if rest else arr

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {sorted(set(map(str, self.devices.flat)))})"


def local_devices(kind: str = "cuda") -> list:
    """The process's devices of ``kind``: every card for ``cuda`` (none
    without one), the one ``cpu`` device for ``cpu``."""
    if kind == "cpu":
        return [torch.device("cpu")]
    if kind != "cuda":
        raise ValueError(f"unsupported device {kind}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = (DATA_AXIS, INDEX_AXIS),
              devices=None) -> Mesh:
    """A mesh over ``devices`` (default: :func:`local_devices`).

    ``shape=[]``/None → every device on the last axis. An explicit shape
    must multiply to the device count. ``devices`` may name a device more
    than once (several shards on one card, or on the CPU)."""
    devices = [torch.device(d) for d in (
        local_devices() if devices is None else devices)]
    n = len(devices)
    if not shape:
        shape = [1] * (len(axis_names) - 1) + [n]
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {list(shape)} != device count {n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(shape)), axis_names)


def default_mesh() -> Optional[Mesh]:
    """A mesh over every card; None on one card or none (plain
    single-device code is both simpler and faster than a 1-device
    mesh)."""
    if len(local_devices()) <= 1:
        return None
    return make_mesh()
