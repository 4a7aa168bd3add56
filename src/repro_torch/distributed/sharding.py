"""Logical-axis sharding rules with divisibility fallback: the port's copy of
``repro.distributed.sharding``'s rule tables and spec logic.

Megatron-style mapping onto the production mesh (pod, data, model):

  logical axis     mesh axes      used by
  ------------     ----------     ---------------------------------
  batch            (pod, data)    activations, token inputs
  vocab            model          embedding table, lm head, logits
  heads_out        model          fused q/k/v out dim (column parallel)
  attn_in          model          o-projection in dim (row parallel)
  ffn_hidden       model          mlp gate/up out, down in
  experts          model          MoE expert dim (EP merged into TP axis)
  expert_cap       data           MoE capacity dim (token parallel)
  seq_kv           data           KV-cache / sequence dim when batch < data
  stack            None           scan-over-layers leading dim

``spec_for`` drops any mesh axis that does not divide the corresponding dim
(replicating that dim instead). A mesh here is given by its axis sizes: a
mapping ``{axis: size}``, or any object with such a ``shape`` mapping. A
spec is a tuple with one entry per leading dim (``None``, an axis name, or
a tuple of names), trailing ``None``s dropped, as ``PartitionSpec`` holds.

The model runs on one device in this package: placing its arrays over
several cards (onto the distributed layer's ``PartMesh``) is not ported, so
:func:`logical_constraint` returns its input unchanged, mesh or not. A
sharding constraint never changes values, so every result is the
reference's.
"""
from __future__ import annotations

import contextlib
import re
import threading
from typing import Mapping, Optional, Sequence, Tuple

# logical axis -> tuple of mesh axis names (tried in order, all that divide)
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "heads_out": ("model",),
    "attn_in": ("model",),
    "ffn_hidden": ("model",),
    "experts": ("model",),
    "expert_cap": ("data",),
    "seq_kv": ("data",),
    "seq_act": ("model",),   # Megatron-SP residual sequence sharding
    "embed": (),
    "stack": (),
    None: (),
}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules = DEFAULT_RULES


_CTX = _Ctx()


def axis_sizes(mesh) -> Mapping[str, int]:
    """A mesh's ``{axis: size}``."""
    return mesh if isinstance(mesh, Mapping) else mesh.shape


@contextlib.contextmanager
def sharding_context(mesh, rules=None):
    """Make ``mesh`` (axis sizes) and ``rules`` the ambient ones."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    _CTX.rules = {**DEFAULT_RULES, **(rules or {})}
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh():
    return _CTX.mesh


def current_rules():
    return _CTX.rules


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]],
             mesh=None, rules=None) -> Tuple:
    """Spec for an array of ``shape`` with logical ``axes``.

    Drops mesh axes that are absent from the mesh or do not divide the dim.
    """
    mesh = mesh or _CTX.mesh
    rules = {**_CTX.rules, **(rules or {})}
    if mesh is None:
        return ()
    sizes = axis_sizes(mesh)
    out = []
    used = set()
    for dim, ax in zip(shape, axes):
        cands = rules.get(ax, ()) if ax else ()
        picked = []
        prod = 1
        for m in cands:
            if m in sizes and m not in used and dim % (prod * sizes[m]) == 0:
                picked.append(m)
                prod *= sizes[m]
        used.update(picked)
        # a multi-axis rule yields a tuple entry even when one axis survives
        # the divisibility filter, so specs stay stable as mesh shapes change
        if not picked:
            out.append(None)
        elif len(cands) > 1:
            out.append(tuple(picked))
        else:
            out.append(picked[0])
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def logical_constraint(x, axes, mesh=None, rules=None):
    """The reference's ``with_sharding_constraint`` via logical axes. The
    port places nothing over several devices: ``x`` comes back as it is."""
    return x


# --------------------------------------------------- param path -> axes ----
# Rules matched in order against 'a/b/c' param paths (first match wins).

PARAM_AXES_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # scanned stacks get a leading 'stack' axis — handled dynamically by rank.
    (r".*embed$", ("vocab", "embed")),
    (r".*lm_head$", ("embed", "vocab")),
    (r".*router$", ("embed", None)),
    (r".*experts/w_gate$", ("experts", "embed", "ffn_hidden")),
    (r".*experts/w_up$", ("experts", "embed", "ffn_hidden")),
    (r".*experts/w_down$", ("experts", "ffn_hidden", "embed")),
    (r".*(wq|wk|wv)$", ("embed", "heads_out")),
    (r".*(bq|bk|bv)$", ("heads_out",)),
    (r".*wo$", ("attn_in", "embed")),
    (r".*w_gate$", ("embed", "ffn_hidden")),
    (r".*w_up$", ("embed", "ffn_hidden")),
    (r".*w_down$", ("ffn_hidden", "embed")),
    (r".*b_up$", ("ffn_hidden",)),
    (r".*(in_proj|x_proj|out_proj|dt_proj)$", ("embed", "ffn_hidden")),  # mamba
    (r".*(tm_[rkvgw]|cm_[rkv])$", ("embed", "ffn_hidden")),              # rwkv
    (r".*(wq_a|wkv_a)$", ("embed", None)),                               # mla lora down
    (r".*(wq_b|wkv_b)$", (None, "heads_out")),                           # mla lora up
    (r".*", ()),  # default: replicate
)


def axes_for_path(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    for pat, axes in PARAM_AXES_RULES:
        if re.fullmatch(pat, path):
            axes = tuple(axes)
            if len(axes) < ndim:  # stacked layers: pad leading dims with None
                axes = (None,) * (ndim - len(axes)) + axes
            elif len(axes) > ndim:
                axes = axes[-ndim:] if ndim else ()
            return axes
    return (None,) * ndim


def param_paths(params, prefix: str = ""):
    """``(path, tensor)`` for every leaf of a params tree of dicts, lists
    and named tuples, with the reference's ``a/b/0/c`` path strings."""
    if isinstance(params, dict):
        for k, v in params.items():
            yield from param_paths(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(params, (list, tuple)) and not hasattr(params, "_fields"):
        for i, v in enumerate(params):
            yield from param_paths(v, f"{prefix}/{i}" if prefix else str(i))
    elif hasattr(params, "_fields"):
        for k in params._fields:
            yield from param_paths(getattr(params, k), f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, params


def params_pspecs(params, mesh, rules=None) -> dict:
    """``{path: spec}`` for every leaf of a params tree."""
    return {path: spec_for(leaf.shape, axes_for_path(path, len(leaf.shape)), mesh, rules)
            for path, leaf in param_paths(params)}
