"""Checkpointing: atomic, resumable: the port of ``repro.checkpoint.manager``.

Layout:  <dir>/step_<n>/arrays.npz + manifest.json   (tmp-dir + atomic rename)

- save() snapshots every leaf to host memory (a copy: the optimizer updates
  the live tensors in place) and then writes; async_=True moves the write
  to a background thread, so training goes on during the I/O.
- restore() returns host tensors shaped by a template; the trainer moves
  them onto its device. ``restore_sharded`` puts them on the current
  ``DeviceMesh`` with the given placements, each rank keeping its chunk:
  elastic, a checkpoint written on one mesh shape restores onto another.
- A DTensor leaf is saved whole: ``save`` gathers it on every rank
  (``full_tensor()``, a collective that every rank calls) and only rank 0
  writes.
- keep_last trims old steps; the manifest carries step/data-state/config-hash
  so a resumed run can check that it continues the same experiment.

The flattened keys are the reference's own: a dict key, a list index or a
named tuple's field name, joined by ``/`` (``opt/m/groups/0/ln1``), so a
checkpoint written by either package restores into the other, and
``config_hash`` agrees because the port's ``ModelConfig`` repr is the
reference's. numpy has no bfloat16 (and the card's machine has no
``ml_dtypes``): a bf16 leaf is stored as its uint16 bits and named in the
manifest's ``"bfloat16"`` list. A bf16 leaf the reference wrote (an
``ml_dtypes`` array in the npz) reads back as raw 2-byte records (``|V2``)
and is taken as the same bits; either restores into a bf16 template leaf.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.tree import map_with_path


def _host(t: torch.Tensor) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    if t.dtype is torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _flatten(tree) -> Dict[str, np.ndarray]:
    flat = {}

    def put(key, leaf):
        flat[key] = _host(leaf) if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        return leaf

    map_with_path(put, tree)
    return flat


def _bf16_keys(tree):
    keys = []
    map_with_path(lambda k, t: keys.append(k) if getattr(t, "dtype", None) is torch.bfloat16
                  else None, tree)
    return keys


def _tensor(arr: np.ndarray, want: torch.dtype) -> torch.Tensor:
    arr = arr if arr.flags.c_contiguous else arr.copy()
    if want is torch.bfloat16:
        if arr.dtype.itemsize != 2:
            raise ValueError(f"checkpoint leaf of dtype {arr.dtype} for a bfloat16 template")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _unflatten_into(template, flat: Dict[str, np.ndarray]):
    def take(key, leaf):
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        arr = flat[key]
        want = tuple(leaf.shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != {want}")
        return _tensor(arr, leaf.dtype)

    return map_with_path(take, template)


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def config_hash(cfg) -> str:
    return hashlib.sha1(repr(cfg).encode()).hexdigest()[:16]


class CheckpointManager:
    def __init__(self, directory, keep_last: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- save ----

    def save(self, step: int, tree, meta: Optional[dict] = None, async_: bool = False):
        flat = _flatten(tree)   # host snapshot taken synchronously (consistent)
        if _rank() != 0:
            return
        meta = dict(meta or {}, step=int(step), time=time.time())
        bf16 = _bf16_keys(tree)
        if bf16:
            meta["bfloat16"] = bf16
        if async_:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, meta), daemon=True)
            self._thread.start()
        else:
            self._write(step, flat, meta)

    def _write(self, step: int, flat, meta):
        tmp = self.dir / f".tmp_step_{step}_{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **flat)
        (tmp / "manifest.json").write_text(json.dumps(meta, indent=1))
        final = self.dir / f"step_{step:09d}"
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)       # atomic publish
        self._trim()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _trim(self):
        steps = self.steps()
        for s in steps[: -self.keep_last] if self.keep_last else []:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # ---------------------------------------------------------- restore ----

    def steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def manifest(self, step: Optional[int] = None) -> dict:
        step = step if step is not None else self.latest_step()
        return json.loads((self.dir / f"step_{step:09d}" / "manifest.json").read_text())

    def restore(self, template, step: Optional[int] = None):
        """The checkpoint at ``step`` (default the latest) as host tensors
        in ``template``'s structure, shapes and dtypes (a template's leaves
        may lie on the ``meta`` device)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        with np.load(self.dir / f"step_{step:09d}" / "arrays.npz") as z:
            flat = {k: z[k] for k in z.files}
        return _unflatten_into(template, flat)

    def restore_sharded(self, template, shardings, step: Optional[int] = None, mesh=None):
        """Elastic restore: the host tensors of :meth:`restore`, each a
        DTensor of ``shardings[its key]`` (placements) on ``mesh`` (default
        the ambient ``DeviceMesh``) keeping this rank's chunk, with nothing
        sent; a key absent from ``shardings`` stays a plain tensor on the
        mesh's device (the optimizer's step count). The mesh may have
        another shape than the one that wrote the checkpoint."""
        from torch.distributed.tensor import distribute_tensor

        from repro_torch.distributed.sharding import current_mesh

        mesh = mesh if mesh is not None else current_mesh()
        if mesh is None:
            raise ValueError("restore_sharded: no DeviceMesh given or ambient")
        host = self.restore(template, step)
        dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
            if mesh.device_type == "cuda" else torch.device(mesh.device_type)
        return map_with_path(lambda k, t: t.to(dev) if k not in shardings else distribute_tensor(
            t.to(dev), mesh, shardings[k], src_data_rank=None), host)
