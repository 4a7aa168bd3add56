"""Production and local meshes: the port of ``repro.launch.mesh``.

The reference makes the production mesh from 512 fake host devices
(``--xla_force_host_platform_device_count``) so that a dry run can lower a
step for 256 or 512 chips on one host. The port's dry run traces on the
``meta`` device, so its production mesh holds no device at all: it is the
axis sizes, which is all ``distributed.sharding.spec_for`` and the dry
run's per-device bytes read. A local mesh holds this host's cards; with one
axis it is the distributed layer's :class:`~repro_torch.core.distributed.PartMesh`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.core.distributed import PartMesh
from repro_torch.core.formats import resolve_device


@dataclass(frozen=True)
class AxisMesh:
    """A mesh given by its axes and their sizes, with no device behind it.

    Example:
        >>> make_production_mesh().shape
        {'data': 16, 'model': 16}
    """

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


@dataclass(frozen=True)
class LocalMesh:
    """Several axes over this host's devices: every device on the first
    axis, the others of size 1 (``devices[0]`` is the home device)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> dict:
        return {a: (len(self.devices) if i == 0 else 1)
                for i, a in enumerate(self.axis_names)}

    @property
    def home(self) -> torch.device:
        return self.devices[0]


def make_production_mesh(*, multi_pod: bool = False) -> AxisMesh:
    """Single pod: (data=16, model=16) = 256 chips; multi-pod adds pod=2."""
    if multi_pod:
        return AxisMesh(("pod", "data", "model"), (2, 16, 16))
    return AxisMesh(("data", "model"), (16, 16))


def make_local_mesh(axes=("data",), device="cuda"):
    """Every visible card (or the host, for ``device="cpu"``) on the first
    of ``axes``, the others sized 1; raises for ``"cuda"`` without a card,
    as ``resolve_device`` does. One axis gives a ``PartMesh`` with a part
    a card."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devs = tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    else:
        devs = (dev,)
    axes = tuple(axes)
    if len(axes) == 1:
        return PartMesh(devs, axes[0])
    return LocalMesh(devs, axes)


def mesh_chips(mesh) -> int:
    return int(math.prod(mesh.shape.values()))
