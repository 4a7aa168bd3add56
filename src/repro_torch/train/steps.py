"""Step builders: train_step (forward, backward and AdamW, with microbatched
gradient accumulation), prefill_step and decode_step: the port of
``repro.train.steps``.

``torch.autograd`` gives the loss's gradients with respect to every
parameter leaf (a leaf the loss does not reach gets zeros, as under
``jax.grad``). With ``microbatches > 1`` the batch's leading dimension is
split, each microbatch's gradients are added into ``accum_dtype`` (f32 by
default) in order, and the sums are divided by ``microbatches``, as the
reference's ``lax.scan`` does; activations live for one microbatch only.
Then ``adamw.update`` writes the step in place.

On DTensors (params and batch placed over a ``DeviceMesh``, the step run
under ``sharding_context(mesh)``) autograd's gradients come back in the
placements their ops give (a replicated parameter's is partial over the
batch's axes). Each microbatch's gradients, and the accumulator, are
redistributed to ``grad_shardings`` (``{path: placements}``, ZeRO-2: a
reduce-scatter, as the reference's constraint makes XLA insert), or
without it to the parameters' placements (an all-reduce). A microbatch
holds the reference's global rows, whichever ranks hold them
(:func:`_microbatches`): the MoE's capacity, its groups and its aux loss
depend on which tokens share a microbatch. The loss comes back a plain
tensor, the same on every rank.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.optim import adamw
from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import map_with_path, rebuild


def _placed(params, grad_shardings):
    """Each leaf's gradient placements, in leaf order (``None`` for a plain
    leaf): ``grad_shardings[path]``, or the parameter's own."""
    from torch.distributed.tensor import DTensor

    out = []

    def one(key, t):
        if not isinstance(t, DTensor):
            out.append(None)
        else:
            out.append(grad_shardings[key] if grad_shardings is not None else t.placements)
        return t

    map_with_path(one, params)
    return out


def _redistribute(g, placements):
    if placements is None or tuple(g.placements) == tuple(placements):
        return g
    return g.redistribute(g.device_mesh, placements)


def _replicated(loss):
    """A DTensor loss as a plain tensor, the same on every rank."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(loss, DTensor):
        return loss
    return loss.redistribute(loss.device_mesh, [Replicate()] * loss.device_mesh.ndim).to_local()


def _microbatches(batch, microbatches: int):
    """The batch's ``microbatches`` equal cuts of every entry's leading dim,
    in order: cut ``i`` holds the global rows ``[i b/mb, (i+1) b/mb)``, as
    the reference's reshape gives them. A DTensor entry has its rows
    gathered first (an all-gather: a cut's rows lie on the shards of
    several ranks), and each cut is placed back as the entry was where the
    same mesh axes divide the cut's rows (each rank keeps its chunk of
    rows it holds, nothing is sent), else left whole on every rank."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.distributed.sharding import is_shard

    cuts = [{} for _ in range(microbatches)]
    for k, x in batch.items():
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
        r = b // microbatches
        if isinstance(x, DTensor):
            mesh, pl = x.device_mesh, tuple(x.placements)
            rows = [d for d, p in enumerate(pl) if is_shard(p) and p.dim == 0]
            whole = tuple(Replicate() if d in rows else p for d, p in enumerate(pl))
            x = x.redistribute(mesh, whole)
            back = pl if r % math.prod(mesh.shape[d] for d in rows) == 0 else whole
        for i in range(microbatches):
            part = x[i * r:(i + 1) * r]
            cuts[i][k] = part.redistribute(mesh, back) if isinstance(x, DTensor) else part
    return cuts


def make_train_step(model, ocfg: adamw.AdamWConfig, microbatches: int = 1,
                    grad_shardings=None, accum_dtype=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics), the
    params and state updated in place; ``metrics`` holds ``loss``,
    ``grad_norm`` and ``lr`` as 0-dim tensors on the params' device.
    ``grad_shardings`` (``{path: placements}``) places DTensor gradients
    (ZeRO-2); see the module docstring.

    The step is in the form a CUDA graph records: it reads nothing from
    the device, writes the params and state into the tensors it was given
    (``adamw.update``), returns its metrics as device tensors, turns grad
    on itself, and unrolls its microbatches; so one capture of it, fed
    each batch into the same tensors, is every later step
    (``repro_torch.train.CapturedTrainStep``)."""

    def grads_of(params, leaves, batch, placements):
        loss = _replicated(model.loss(params, batch))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        return loss.detach(), [_redistribute(g, pl) for g, pl in zip(grads, placements)]

    @torch.enable_grad()    # even where the caller turned it off: a capture runs it under no_grad
    def step(params, opt_state, batch):
        leaves = tree_leaves(params)
        placements = _placed(params, grad_shardings)
        for t in leaves:
            t.requires_grad_(True)
        try:
            if microbatches > 1:
                adt = accum_dtype or torch.float32
                gsum, lsum = None, 0.0
                for mb in _microbatches(batch, microbatches):
                    loss, grads = grads_of(params, leaves, mb, placements)
                    if gsum is None:
                        gsum = [g.to(adt, copy=True) for g in grads]
                    else:
                        for acc, g in zip(gsum, grads):
                            acc.add_(g.to(adt))
                    lsum = lsum + loss
                    del grads
                grads = [g.div_(microbatches) for g in gsum]
                loss = lsum / microbatches
            else:
                loss, grads = grads_of(params, leaves, batch, placements)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        params, opt_state, metrics = adamw.update(ocfg, rebuild(params, grads),
                                                  opt_state, params)
        return params, opt_state, dict(metrics, loss=loss)

    return step


def make_prefill_step(model):
    def step(params, tokens, extra: Optional[Dict[str, Any]] = None):
        return model.prefill(params, tokens, extra)
    return step


def make_decode_step(model):
    def step(params, token, caches, pos):
        return model.decode_step(params, token, caches, pos)
    return step
