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
(replicating that dim instead). A mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims, or, where only
the sizes matter (the dry run's per-device bytes), its axis sizes: a mapping
``{axis: size}``, or any object with such a ``shape`` mapping. A spec is a
tuple with one entry per leading dim (``None``, an axis name, or a tuple of
names), trailing ``None``s dropped, as ``PartitionSpec`` holds.

The translation of ``NamedSharding(mesh, spec)`` is a DTensor's placements:
:func:`placements_for` gives one ``Shard(d)`` or ``Replicate()`` per mesh
dim. A dim split over two mesh axes takes its chunks in the spec's order,
major first, as JAX does: in mesh order that is DTensor's default; out of
mesh order (``seq_kv`` over ``("model", "data")``) the minor axis gets a
``_StridedShard``, so that every rank holds the reference's chunk.

:func:`logical_constraint` is the reference's ``with_sharding_constraint``:
under an ambient ``DeviceMesh`` (:func:`sharding_context`) it redistributes
a DTensor to its logical axes' placements; on a plain tensor, or with no
``DeviceMesh`` about, it returns its input, so every one-device path keeps
its bits. A sharding context with a ``DeviceMesh`` also lets plain tensors
meet DTensors as replicated ones (DTensor's ``implicit_replication``): the
model makes its masks, positions and accumulators as plain tensors of the
global shapes.
"""
from __future__ import annotations

import contextlib
import math
import re
import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.distributed.tensor.placement_types import _StridedShard

from repro_torch.tree import map_with_path

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
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return mesh if isinstance(mesh, Mapping) else mesh.shape


def is_shard(placement) -> bool:
    """``Shard`` or ``_StridedShard`` (not a ``Shard`` subclass in every
    PyTorch)."""
    return isinstance(placement, (Shard, _StridedShard))


_IMPLICIT = threading.Lock()
_implicit_depth = 0


@contextlib.contextmanager
def _implicit_replication():
    """DTensor's ``implicit_replication`` (a process-wide switch that its
    own exit turns off), entered by the outermost holder only: autograd's
    recompute thread re-enters the sharding context while the step that
    started it still holds the switch."""
    global _implicit_depth
    with _IMPLICIT:
        _implicit_depth += 1
        outer = _implicit_depth == 1
    ctx = implicit_replication() if outer else contextlib.nullcontext()
    try:
        with ctx:
            yield
    finally:
        with _IMPLICIT:
            _implicit_depth -= 1


@contextlib.contextmanager
def sharding_context(mesh, rules=None):
    """Make ``mesh`` (a ``DeviceMesh`` or axis sizes) and ``rules`` the
    ambient ones. A ``DeviceMesh`` also lets plain tensors meet DTensors as
    replicated ones while the context is held."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    _CTX.rules = {**DEFAULT_RULES, **(rules or {})}
    try:
        with _implicit_replication() if isinstance(mesh, DeviceMesh) else \
                contextlib.nullcontext():
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


def placements_for(spec: Tuple, mesh: DeviceMesh) -> Tuple:
    """The DTensor placements of ``spec`` on ``mesh``: one ``Shard(d)`` or
    ``Replicate()`` per mesh dim. A dim split over several axes takes its
    chunks in the spec's order, major first (JAX's): an axis that comes
    before a more major one in mesh order shards with a ``_StridedShard``
    whose split factor is the sizes of those more major axes.

    Example (on a ``("data", "model")`` mesh of sizes (2, 4)):
        ``placements_for((("model", "data"),), mesh)`` is
        ``(_StridedShard(0, sf=4), Shard(0))``: rank (d, m) holds chunk
        ``m * 2 + d`` of 8.
    """
    names = tuple(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for i, ax in enumerate(axes):
            pos = names.index(ax)
            sf = math.prod(sizes[a] for a in axes[:i] if names.index(a) > pos)
            out[pos] = _StridedShard(d, split_factor=sf) if sf > 1 else Shard(d)
    return tuple(out)


def dtensor_mesh(x) -> Optional[DeviceMesh]:
    """The ambient ``DeviceMesh`` when ``x`` is a DTensor, else ``None``:
    whether a region runs sharded."""
    mesh = _CTX.mesh
    return mesh if isinstance(x, DTensor) and isinstance(mesh, DeviceMesh) else None


def named_sharding(shape, axes, mesh=None, rules=None) -> Optional[Tuple]:
    """The placements of an array of ``shape`` with logical ``axes`` on a
    ``DeviceMesh`` (the ambient one by default); ``None`` with no mesh."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return None
    return placements_for(spec_for(shape, axes, mesh, rules), mesh)


def local_region(fn, mesh: DeviceMesh, args, axes, outs):
    """``fn`` on each rank's shards, in a ``local_map`` region: ``args``
    (DTensors, or plain tensors that every rank holds whole) placed by
    their logical ``axes`` (one tuple each, :func:`named_sharding`), and
    output ``i`` in the placements of ``args[outs[i]]``. For a region whose
    work splits into independent parts along every mesh dim that splits an
    argument (batch rows, heads, channels): an argument whole along such a
    dim feeds every part, so its gradient is partial there."""
    from torch.distributed.tensor import Partial, distribute_tensor
    from torch.distributed.tensor.experimental import local_map

    pls = [named_sharding(a.shape, ax, mesh) for a, ax in zip(args, axes)]
    split = {i for pl in pls for i, p in enumerate(pl) if is_shard(p)}
    grads = tuple(tuple(Partial() if i in split and not is_shard(p) else p
                        for i, p in enumerate(pl)) for pl in pls)
    args = [a if isinstance(a, DTensor) else distribute_tensor(a, mesh, pl, src_data_rank=None)
            for a, pl in zip(args, pls)]
    out = tuple(list(pls[i]) for i in outs)
    return local_map(fn, out_placements=out if len(out) > 1 else out[0],
                     in_placements=tuple(pls), in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _grad_as_placed(y):
    """``y``; under autograd a DTensor's gradient is brought to ``y``'s own
    placements (an identity redistribute, whose backward does that), a
    partial sum's to replicated ones. An op's backward gives its input's
    gradient in the placements of its own strategy: after a reshape
    DTensor may then be unable to reshape it back (a dim sharded over axes
    that do not divide its first piece), or may reduce it only after
    gathering it (a partial sum of all tokens where one of each rank's
    rows would do)."""
    if isinstance(y, DTensor) and y.requires_grad and torch.is_grad_enabled():
        return y.redistribute(y.device_mesh, y.placements)
    return y


def split_dim(x, dim: int, sizes: Sequence[int]):
    """``x`` with dim ``dim`` reshaped into ``sizes``. A DTensor whose
    ``dim`` is sharded over mesh axes that do not divide ``sizes[0]`` (8 kv
    heads of a 16-way ``model`` axis) has that dim gathered first, as XLA's
    partitioner reshards there: DTensor cannot split a sharded dim so. The
    result's gradient comes back in its placements (:func:`_grad_as_placed`)."""
    dim %= x.ndim
    if isinstance(x, DTensor):
        over = [i for i, p in enumerate(x.placements) if is_shard(p) and p.dim == dim]
        if sizes[0] % math.prod(x.device_mesh.shape[i] for i in over):
            x = x.redistribute(x.device_mesh, [Replicate() if i in over else p
                                               for i, p in enumerate(x.placements)])
    return _grad_as_placed(x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:]))


def merge_dims(x, dim: int, n: int = 2):
    """``x`` with dims ``dim .. dim + n - 1`` merged into one; the result's
    gradient comes back in its placements (:func:`_grad_as_placed`), from
    which DTensor can split it into the dims again."""
    dim %= x.ndim
    return _grad_as_placed(x.reshape(*x.shape[:dim], math.prod(x.shape[dim:dim + n]),
                                     *x.shape[dim + n:]))


def logical_constraint(x, axes, mesh=None, rules=None):
    """The reference's ``with_sharding_constraint`` via logical axes: a
    DTensor under a ``DeviceMesh`` (given or ambient) redistributed to the
    axes' placements; anything else comes back as it is."""
    mesh = mesh or _CTX.mesh
    if not isinstance(x, DTensor) or not isinstance(mesh, DeviceMesh):
        return x
    return x.redistribute(mesh, named_sharding(x.shape, axes, mesh, rules))


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


def params_shardings(params, mesh: DeviceMesh, rules=None) -> Dict[str, Tuple]:
    """``{path: placements}`` for every leaf of a params tree (tensors, on
    the ``meta`` device too), in the reference's leaf order."""
    out: Dict[str, Tuple] = {}
    map_with_path(lambda path, leaf: out.__setitem__(path, placements_for(
        spec_for(leaf.shape, axes_for_path(path, len(leaf.shape)), mesh, rules), mesh)), params)
    return out


def distribute(tree, mesh: DeviceMesh, shardings: Mapping[str, Tuple]):
    """``tree`` with every leaf a DTensor of ``shardings[its key]`` that
    keeps only this rank's chunk (``src_data_rank=None``: every rank holds
    the same values, so nothing is sent)."""
    from torch.distributed.tensor import distribute_tensor

    return map_with_path(lambda key, t: distribute_tensor(t, mesh, shardings[key],
                                                          src_data_rank=None), tree)
