"""Production and local meshes: the port of ``repro.launch.mesh``.

The reference makes the production mesh from 512 fake host devices
(``--xla_force_host_platform_device_count``) so that a dry run can lower a
step for 256 or 512 chips on one host. The port's dry run traces on the
``meta`` device, so its production mesh holds no device at all: it is the
axis sizes, which is all ``distributed.sharding.spec_for`` and the dry
run's per-device bytes read. A local mesh holds this host's cards; with one
axis it is the distributed layer's :class:`~repro_torch.core.distributed.PartMesh`.

The model's sharding runs on a ``torch.distributed`` ``DeviceMesh``, which
:func:`device_mesh` makes over the process group: NCCL with one rank a card,
``gloo`` on the host, or, for the dry run, the ``"fake"`` group, whose
collectives move nothing, with one rank standing for each chip of the
production mesh.
"""
from __future__ import annotations

import contextlib
import math
import os
from dataclasses import dataclass
from typing import Sequence, Tuple

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


#: ``device`` of :func:`device_mesh` -> (process group backend, mesh device type).
_BACKENDS = {"cuda": ("nccl", "cuda"), "cpu": ("gloo", "cpu"), "meta": ("fake", "cpu")}


def _world_from_env() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"))


def device_mesh(axis_names: Sequence[str], sizes: Sequence[int], device="cuda"):
    """A ``DeviceMesh`` of ``sizes`` with dims ``axis_names`` over the
    process group of ``device``: ``"cuda"`` NCCL, one rank a card (the
    rank's card is ``LOCAL_RANK``); ``"cpu"`` ``gloo``; ``"meta"`` the
    ``"fake"`` group of the dry run, rank 0 of ``prod(sizes)``, whose
    collectives send nothing (its tensors live on ``meta``).

    An initialised group of the same world is used as it is (``torchrun``,
    or the caller's ``init_process_group``). Otherwise the group starts
    here: from ``torchrun``'s environment, or alone for a world of one; a
    world of several ranks with no environment raises. A fake group of
    another world is torn down and started again (256 <-> 512 chips); a
    real group of another world raises. Use :func:`mesh_scope` to tear down
    what this started.

    The fake group comes from a module internal to PyTorch
    (``torch.testing._internal.distributed.fake_pg``), imported here and
    nowhere else in the package.

    Example:
        >>> mesh = device_mesh(("data", "model"), (16, 16), device="meta")
        >>> dict(zip(mesh.mesh_dim_names, mesh.shape))
        {'data': 16, 'model': 16}
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device(device).type
    if dev not in _BACKENDS:
        raise ValueError(f"device_mesh: no process group for device {device!r}")
    backend, mesh_type = _BACKENDS[dev]
    world = math.prod(sizes)
    if dist.is_initialized():
        have = dist.get_backend()
        if dist.get_world_size() != world or have != backend:
            if have != "fake" or backend != "fake":
                raise ValueError(f"device_mesh: the process group is {have} over "
                                 f"{dist.get_world_size()} ranks; a {tuple(sizes)} mesh on "
                                 f"{device} needs {backend} over {world}")
            dist.destroy_process_group()
    if not dist.is_initialized():
        if backend == "fake":
            from torch.testing._internal.distributed.fake_pg import FakeStore

            dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
        else:
            if backend == "nccl":
                if not torch.cuda.is_available():
                    raise RuntimeError("device_mesh: device='cuda' without a card")
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            if _world_from_env():
                dist.init_process_group(backend)
            elif world == 1:
                dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
            else:
                raise RuntimeError(f"device_mesh: a world of {world} ranks needs torchrun's "
                                   f"environment or an initialised process group")
            if dist.get_world_size() != world:
                raise ValueError(f"device_mesh: {dist.get_world_size()} ranks started, the "
                                 f"mesh {tuple(sizes)} needs {world}")
    return init_device_mesh(mesh_type, tuple(sizes), mesh_dim_names=tuple(axis_names))


@contextlib.contextmanager
def mesh_scope(axis_names: Sequence[str], sizes: Sequence[int], device="cuda"):
    """:func:`device_mesh` as a context manager: the process group that it
    started is destroyed on exit (one it found is left)."""
    import torch.distributed as dist

    had = dist.is_initialized()
    mesh = device_mesh(axis_names, sizes, device)
    try:
        yield mesh
    finally:
        if not had and dist.is_initialized():
            dist.destroy_process_group()

