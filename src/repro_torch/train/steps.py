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
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.optim import adamw
from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import rebuild


def make_train_step(model, ocfg: adamw.AdamWConfig, microbatches: int = 1,
                    grad_shardings=None, accum_dtype=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics), the
    params and state updated in place; ``metrics`` holds ``loss``,
    ``grad_norm`` and ``lr`` as 0-dim tensors on the params' device."""
    if grad_shardings is not None:
        raise NotImplementedError("make_train_step: grad_shardings (ZeRO-2) waits with the "
                                  "model's sharding over several cards, ROADMAP item 9")

    def grads_of(params, leaves, batch):
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        return loss.detach(), grads

    def step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        try:
            if microbatches > 1:
                def split(x):
                    b = x.shape[0]
                    if b % microbatches:
                        raise ValueError(f"batch {b} does not split into {microbatches} "
                                         f"microbatches")
                    return x.reshape(microbatches, b // microbatches, *x.shape[1:])

                mbs = {k: split(v) for k, v in batch.items()}
                adt = accum_dtype or torch.float32
                gsum, lsum = None, 0.0
                for i in range(microbatches):
                    loss, grads = grads_of(params, leaves, {k: v[i] for k, v in mbs.items()})
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
                loss, grads = grads_of(params, leaves, batch)
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
