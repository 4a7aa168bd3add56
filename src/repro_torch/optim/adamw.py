"""AdamW + cosine schedule + global-norm clipping: the port of
``repro.optim.adamw``.

The arithmetic is the reference's, in its order of operations: the clip
scale from the global norm, the moments, the bias corrections, the
decoupled weight decay on the f32 master, and the master kept beside bf16
parameters when ``keep_master``. Every scalar (norm, scale, step, learning
rate, bias corrections) stays a 0-dim tensor on the parameters' device, so
an update reads nothing back to the host.

Unlike the reference's functional update, :func:`update` writes in place,
leaf by leaf and in chunks of ``CHUNK`` elements: at full width one expert
leaf of qwen3-moe-235b-a22b is 128 x 4096 x 1536 f32 (3.22 GB), and a
functional update would hold about six temporaries of that size per leaf.
Here the temporaries are a chunk's. It returns the same (updated) trees,
its step counter advanced in place.

On DTensors (the model's sharding over a ``DeviceMesh``) the update runs on
each leaf's local shard (``to_local()``), chunk by chunk as above, so no
sharded leaf is flattened (which would redistribute it). A gradient in
other placements than its moments (ZeRO-2's) is first redistributed to
theirs, and a parameter kept in other placements than its master (ZeRO's
bf16 parameters beside an FSDP master) is written back from the master
through a redistribute. :func:`global_norm` sums every leaf's local
squares and adds them over the ranks that hold distinct shards of it only
(see there).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    m: Any              # like params (f32)
    v: Any              # like params (f32)
    master: Any = None  # f32 master copy when the params are bf16 (None otherwise)


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    keep_master: bool = False   # True: params are bf16, master f32 in state


#: Elements of a leaf updated at a time (256 MB of f32 temporaries).
CHUNK = 1 << 26


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``; f32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init(params, keep_master: bool = False, shardings=None) -> AdamWState:
    """Zero moments (f32) like ``params``, step 0 on their device, and the
    f32 master when ``keep_master``. DTensor params give DTensor moments and
    master of their placements, or of ``shardings`` (``{path: placements}``,
    the reference's FSDP optimizer rules) where given."""
    first = leaves(params)[0]
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    master = tree_map(lambda p: p.detach().to(torch.float32, copy=True), params) if keep_master \
        else None
    state = AdamWState(torch.zeros((), dtype=torch.int32, device=first.device),
                       tree_map(zeros, params), tree_map(zeros, params), master)
    if shardings is None:
        return state
    from repro_torch.tree import map_with_path

    def place(tree):
        return map_with_path(lambda k, t: t.redistribute(t.device_mesh, shardings[k]), tree)

    return AdamWState(state.step, place(state.m), place(state.v),
                      place(master) if master is not None else None)


def _square_sum(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1)
    if flat.numel() <= CHUNK:
        return torch.sum(torch.square(flat.to(torch.float32)))
    return sum(torch.sum(torch.square(c.to(torch.float32))) for c in flat.split(CHUNK))


def _split_dims(t) -> tuple:
    """The mesh dims of size > 1 over which a DTensor holds distinct shards
    (``()`` for a plain tensor)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import is_shard

    if not isinstance(t, DTensor):
        return ()
    mesh = t.device_mesh
    return tuple(i for i, pl in enumerate(t.placements) if is_shard(pl) and mesh.size(i) > 1)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (a leaf above
    ``CHUNK`` elements summed chunk by chunk).

    On DTensors each leaf's local square sum is added, in leaf order, into
    the running sum of the leaves split over the same mesh dims; each such
    sum is then added over those dims only (one all-reduce each), so a
    leaf replicated over a dim counts once, not once per rank. Where every
    dim that splits a leaf has size 1 this is the one-device sum, bit for
    bit. The result is a plain tensor, the same on every rank."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    with torch.no_grad():
        groups, mesh = {}, None
        for x in leaves(tree):
            dims = _split_dims(x)
            if isinstance(x, DTensor):
                mesh, x = x.device_mesh, x.to_local()
            s = _square_sum(x)
            groups[dims] = s if dims not in groups else groups[dims] + s
        total = None
        for dims, s in groups.items():
            if dims:
                s = DTensor.from_local(s, mesh, [Partial() if i in dims else Replicate()
                                                 for i in range(mesh.ndim)], run_check=False)
                s = s.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
            total = s if total is None else total + s
        return torch.sqrt(total)


def _flat(t: torch.Tensor) -> torch.Tensor:
    if not t.is_contiguous():
        raise ValueError("adamw.update: parameters, moments and masters must be contiguous "
                         "(they are updated in place)")
    return t.view(-1)


def _locals(p, g, m, v, mp):
    """The local shards the update runs on, and a function that writes a
    parameter kept in other placements than its moments back into it."""
    from torch.distributed.tensor import DTensor

    if not isinstance(m, DTensor):
        return p, g, m, v, mp, lambda: None
    mesh, pl = m.device_mesh, m.placements
    if g.placements != pl:
        g = g.redistribute(mesh, pl)
    if mp is not None and mp.placements != pl:
        raise ValueError("adamw.update: the master and the moments differ in placements")
    if p.placements == pl:
        return p.to_local(), g.to_local(), m.to_local(), v.to_local(), \
            mp.to_local() if mp is not None else None, lambda: None
    # the parameter's shard lives elsewhere: update a copy in the moments'
    # placements, then redistribute it into the parameter
    work = DTensor.from_local(p.redistribute(mesh, pl).to_local().clone(), mesh, pl,
                              run_check=False, shape=p.shape, stride=p.stride())

    def put_back():
        p.to_local().copy_(work.redistribute(p.device_mesh, p.placements).to_local())

    return work.to_local(), g.to_local(), m.to_local(), v.to_local(), \
        mp.to_local() if mp is not None else None, put_back


def update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """One AdamW step, in place: returns ``(params, state, {"grad_norm",
    "lr"})`` with ``params``, ``state.step``, ``state.m``, ``state.v`` and
    ``state.master`` the same tensors, updated (the step counter advanced
    by one). ``grads`` is read only. The update reads nothing from the
    device and makes no tensor on the host, so a CUDA graph can hold it
    (``repro_torch.train.CapturedTrainStep``)."""
    with torch.no_grad():
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        # the counter advances in place and the bases of the bias
        # corrections are made on the device: a CUDA graph replays this
        # update on the tensors it was captured with, and a tensor made on
        # the host is a copy a capture refuses
        step = state.step.add_(1)
        lr = schedule(cfg, step)
        stepf = step.to(torch.float32)
        b1, b2 = (torch.full((), b, dtype=torch.float32, device=stepf.device)
                  for b in (cfg.b1, cfg.b2))
        b1c = 1 - torch.pow(b1, stepf)
        b2c = 1 - torch.pow(b2, stepf)
        flat_p, flat_g = leaves(params), leaves(grads)
        flat_m, flat_v = leaves(state.m), leaves(state.v)
        flat_mp = leaves(state.master) if state.master is not None else [None] * len(flat_p)
        if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v) == len(flat_mp):
            raise ValueError("adamw.update: params, grads and state differ in structure")
        for p_, g, m, v, mp in zip(flat_p, flat_g, flat_m, flat_v, flat_mp):
            # DTensors: every operand on the moments' placements, locally
            p, g, m, v, mp, put_back = _locals(p_, g, m, v, mp)
            pf, gf, mf, vf = _flat(p), g.reshape(-1), _flat(m), _flat(v)
            mpf = _flat(mp) if mp is not None else None
            own = mpf is None and p.dtype is torch.float32  # the parameter is its master
            for lo in range(0, pf.numel(), CHUNK):
                sl = slice(lo, lo + CHUNK)
                # mp: the f32 master (the parameter itself when it is f32
                # and no master is kept)
                if mpf is not None:
                    mpc = mpf[sl]
                elif own:
                    mpc = pf[sl]
                else:
                    mpc = pf[sl].to(torch.float32)
                gc = gf[sl].to(torch.float32) * scale
                mc, vc = mf[sl], vf[sl]
                t = gc * (1 - cfg.b1)
                mc.mul_(cfg.b1).add_(t)
                torch.mul(gc, 1 - cfg.b2, out=t).mul_(gc)
                vc.mul_(cfg.b2).add_(t)
                d = mc / b1c
                d.div_(torch.div(vc, b2c, out=gc).sqrt_().add_(cfg.eps))
                d.add_(torch.mul(mpc, cfg.weight_decay, out=t))
                mpc.sub_(d.mul_(lr))
                if not own:
                    pf[sl].copy_(mpc)
            put_back()
        return params, state, {"grad_norm": gnorm, "lr": lr}
