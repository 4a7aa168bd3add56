"""Weights carried across from the reference: ``params_from_reference``
turns the reference's ``model.init(...)`` tree, with its leaves as numpy
arrays, into the port's parameters, so both packages run one model."""
from __future__ import annotations

from repro_torch.core.formats import resolve_device, to_tensor
from repro_torch.distributed.sharding import param_paths


def _convert(node, device):
    if isinstance(node, dict):
        return {k: _convert(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, device) for v in node]
    return to_tensor(node, node.dtype, device)


def params_from_reference(cfg, tree, device="cuda"):
    """The port's parameters from the reference's (numpy leaves, e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``): the same per-group
    layer stacks, shapes, dtypes and values, on ``device``. Raises where
    the tree's paths or shapes differ from the port's model of ``cfg``."""
    from .model import build_model

    params = _convert(tree, resolve_device(device))
    want = {p: tuple(t.shape) for p, t in param_paths(build_model(cfg, "meta").init())}
    got = {p: tuple(t.shape) for p, t in param_paths(params)}
    if want != got:
        raise ValueError(f"params_from_reference: the tree does not fit {cfg.name}: "
                         f"missing {sorted(set(want) - set(got))}, extra "
                         f"{sorted(set(got) - set(want))}, shapes differ at "
                         f"{sorted(p for p in want.keys() & got.keys() if want[p] != got[p])}")
    return params
