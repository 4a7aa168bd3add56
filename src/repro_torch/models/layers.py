"""Primitive layers (PyTorch, params = plain dicts of tensors): the port of
``repro.models.layers``.

Conventions, as the reference's:
  - params are created by ``init_*`` helpers drawing from an :class:`Init`
    (an explicit ``torch.Generator`` and device)
  - compute runs in cfg.activation_dtype (bf16) with f32 where it matters
    (norms, softmax, losses); each weight is cast to the activation dtype
    where it is used, which costs nothing for a weight already held in it
  - weight names are stable: the sharding rules in
    ``repro_torch.distributed.sharding`` match on path regexes
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


class Init:
    """Where parameters are drawn: a ``torch.Generator`` (``None`` on the
    ``meta`` device, which allocates nothing) and the device they live on.
    ``weight_dtype`` (default f32, the reference's) is the dtype every
    weight is stored in, except the router, which the reference uses in
    f32; a weight is drawn in f32 and rounded to it once."""

    def __init__(self, generator: Optional[torch.Generator] = None, device="cpu",
                 weight_dtype: torch.dtype = torch.float32):
        self.generator = generator
        self.device = torch.device(device)
        self.weight_dtype = weight_dtype

    def normal(self, shape, scale: float, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        gen = None if self.device.type == "meta" else self.generator
        w = torch.randn(shape, generator=gen, device=self.device, dtype=torch.float32)
        return (w * scale).to(dtype or self.weight_dtype)

    def uniform(self, shape) -> torch.Tensor:
        """f32 draws in [0, 1)."""
        gen = None if self.device.type == "meta" else self.generator
        return torch.rand(shape, generator=gen, device=self.device, dtype=torch.float32)

    def full(self, shape, value: float, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype or self.weight_dtype, device=self.device)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(shape, dtype=self.weight_dtype, device=self.device)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.weight_dtype, device=self.device)


def dense_init(init: Init, in_dim: int, out_dim: int, scale: Optional[float] = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return init.normal((in_dim, out_dim), scale)


def embed_init(init: Init, vocab: int, dim: int):
    return init.normal((vocab, dim), 0.02)


def embed_lookup(table, tokens):
    """``table``'s rows at ``tokens``. On a ``DeviceMesh`` (a DTensor table
    under ``sharding_context``) the lookup is vocab-parallel, in a
    ``local_map`` region: each rank looks its ids up in its own rows of the
    vocab (zeros for an id outside them) for its own batch rows, and the
    result is a partial sum over the vocab's axes (DTensor's own lookup
    gives a masked partial whose gradient it cannot redistribute). Where
    the vocab is whole the region is ``F.embedding`` times ones."""
    from repro_torch.distributed.sharding import dtensor_mesh, is_shard

    mesh = dtensor_mesh(table)
    if mesh is None:
        return F.embedding(tokens, table)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    n = mesh.ndim
    vocab = [i for i, p in enumerate(table.placements) if is_shard(p) and p.dim == 0]
    tok = list(tokens.placements) if isinstance(tokens, DTensor) else [Replicate()] * n
    batch = [i for i in range(n) if i not in vocab and is_shard(tok[i]) and tok[i].dim == 0]
    t_in = [Shard(0) if i in vocab else Replicate() for i in range(n)]
    k_in = [Shard(0) if i in batch else Replicate() for i in range(n)]
    out = [Shard(0) if i in batch else Partial() if i in vocab else Replicate()
           for i in range(n)]
    t_grad = [Shard(0) if i in vocab else Partial() if i in batch else Replicate()
              for i in range(n)]
    sizes = mesh.shape

    def lookup(rows, ids):
        first = 0
        for i in vocab:
            first = first * sizes[i] + mesh.get_local_rank(i)
        first *= rows.shape[0]
        idx = ids - first
        inside = (idx >= 0) & (idx < rows.shape[0])
        got = F.embedding(torch.where(inside, idx, torch.zeros_like(idx)), rows)
        return got * inside[..., None].to(got.dtype)

    return local_map(lookup, out_placements=out, in_placements=(t_in, k_in),
                     in_grad_placements=(t_grad, k_in), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


def rmsnorm(x, w, eps: float = 1e-5):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def layernorm(x, w, b, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, hd), positions: broadcastable to (..., S). The
    reference's half-split rotation: the first and second halves of each
    head are the pair's two coordinates."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    ang = positions[..., None].float() * freqs                # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def gelu_mlp(x, w_up, b_up, w_down, b_down):
    return F.gelu(x @ w_up + b_up, approximate="tanh") @ w_down + b_down


def init_mlp(init: Init, d_model: int, d_ff: int):
    return {
        "w_gate": dense_init(init, d_model, d_ff),
        "w_up": dense_init(init, d_model, d_ff),
        "w_down": dense_init(init, d_ff, d_model),
    }


def apply_mlp(p, x):
    return swiglu(x, p["w_gate"].to(x.dtype), p["w_up"].to(x.dtype),
                  p["w_down"].to(x.dtype))
