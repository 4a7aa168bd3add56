"""Gradient compression for the DP all-reduce (QSGD-flavoured int8 with
error feedback): the port of ``repro.distributed.compression`` onto a
:class:`~repro_torch.core.distributed.PartMesh`.

Scheme (per worker vector, the reference's inside ``shard_map``):
  1. residual-corrected gradient g' = g + err
  2. chunked int8 quantisation (per-chunk absmax scale)
  3. all_to_all the int8 shards (each worker owns 1/DP of the vector)
  4. local dequant + sum -> owned shard (exact f32 accumulation)
  5. all_gather the reduced shards (int8 again, one more quantisation)
  6. new err = g' - dequant(quant(g'))  (error feedback)

Wire bytes ~ 2N int8 vs ~8N for ring-f32-all-reduce: ~4x reduction.

Here one process drives every part: the all_to_all hands part ``p`` the
``p``-th shard of every source and the all_gather hands every part all the
reduced shards, each moved with ``.to(part_device)`` (as the distributed
layer's ``halo_window`` moves halos); on one device they are indexing. The
sums over sources run left to right, so a result repeats its bits.

As in the reference, ``int8_psum_mean`` quantises at the default chunk of
256 whatever ``CompressedAllReduce.chunk`` says, while the error feedback
quantises at ``chunk``: with ``chunk != 256`` the residual is not what was
sent, and ``n_pad / DP`` must be a multiple of 256.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.core.distributed import PartMesh, mesh_parts


def _quant(x: torch.Tensor, chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    n = x.shape[0]
    npad = -(-n // chunk) * chunk
    xp = torch.zeros((npad,), dtype=x.dtype, device=x.device)
    xp[:n] = x
    xp = xp.reshape(-1, chunk)
    # by a device tensor: ATen's CUDA division by a host scalar multiplies by
    # its reciprocal, whose rounding gave the card other scales (and codes)
    # than the host's true division, the reference's
    scale = torch.amax(torch.abs(xp), dim=1, keepdim=True) / torch.full((), 127.0,
                                                                       device=x.device)
    # torch.round, as jnp.round, rounds half to even
    q = torch.clamp(torch.round(xp / torch.clamp(scale, min=1e-12)), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequant(q: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    return (q.to(torch.float32) * scale).reshape(-1)[:n]


def _fold(terms: Sequence[torch.Tensor]) -> torch.Tensor:
    """``terms`` added left to right."""
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def int8_psum_mean(xs: torch.Tensor, mesh: PartMesh, axis: str = "data") -> torch.Tensor:
    """Mean over the parts of ``axis`` with int8 wire format.

    ``xs``: ``(nparts, n)`` f32, row ``p`` part ``p``'s vector, ``n``
    divisible by ``nparts`` (the caller pads). Returns ``(nparts, n)`` on
    the mesh's home device: row ``p`` is what part ``p`` holds after the
    all_gather (every row the same).
    """
    nparts = mesh_parts(mesh, axis)
    n = xs.shape[1]
    shard = n // nparts
    # 1 each part quantises its full vector, split into worker shards
    sent = []
    for p, dev in enumerate(mesh.devices):
        q, s = _quant(xs[p].to(dev))
        chunk = q.shape[1]
        sent.append((q.reshape(nparts, shard // chunk, chunk),
                     s.reshape(nparts, shard // chunk, 1)))
    # 2 all_to_all: part p receives every source's contribution to ITS shard,
    # then dequantises and sums them (sources in order)
    reduced = []
    for p, dev in enumerate(mesh.devices):
        mine = _fold([q[p].to(dev).to(torch.float32) * s[p].to(dev) for q, s in sent]) / nparts
        # 3 requantise the reduced shard for the all_gather
        reduced.append(_quant(mine.reshape(-1)))
    # 4 all_gather: every part receives all the reduced shards
    outs: List[torch.Tensor] = []
    for dev in mesh.devices:
        qg = torch.stack([q.to(dev) for q, _ in reduced])
        sg = torch.stack([s.to(dev) for _, s in reduced])
        outs.append((qg.to(torch.float32) * sg).reshape(-1)[:n].to(mesh.home))
    return torch.stack(outs)


class CompressedAllReduce:
    """Mean per-worker gradient vectors over a DP mesh axis with int8 wire
    format + error feedback.

    Inputs are *stacked* per-worker: vec ``(DP, n_pad)``, row ``p`` part
    ``p``'s; err has the same shape. Each part adds its residual,
    quantises, takes part in the all_to_all/all_gather pipeline, and keeps
    what the wire lost.

    Example:
        >>> mesh = PartMesh.on("cpu", parts=4)
        >>> car = CompressedAllReduce(mesh, chunk=64)
        >>> car.padded_len(1000), tuple(car.init_error(1000).shape)
        (1024, (4, 1024))
    """

    def __init__(self, mesh: PartMesh, axis: str = "data", chunk: int = 256):
        self.mesh = mesh
        self.axis = axis
        self.nparts = mesh_parts(mesh, axis)
        self.chunk = chunk

    def padded_len(self, n: int) -> int:
        step = self.nparts * self.chunk
        return -(-n // step) * step

    def init_error(self, n: int) -> torch.Tensor:
        return torch.zeros((self.nparts, self.padded_len(n)), dtype=torch.float32,
                           device=self.mesh.home)

    def __call__(self, vec_stacked: torch.Tensor, err_stacked: torch.Tensor):
        """vec/err: ``(DP, n_pad)`` f32. Returns (mean ``(n_pad,)``, new_err
        ``(DP, n_pad)``), both on the mesh's home device."""
        v = torch.stack([(vec_stacked[p].to(dev) + err_stacked[p].to(dev)).to(self.mesh.home)
                         for p, dev in enumerate(self.mesh.devices)])
        red = int8_psum_mean(v, self.mesh, self.axis)
        new_err = []
        for p, dev in enumerate(self.mesh.devices):
            vp = v[p].to(dev)
            q, s = _quant(vp, self.chunk)
            new_err.append((vp - _dequant(q, s, vp.shape[0])).to(self.mesh.home))
        return red.mean(dim=0), torch.stack(new_err)  # all rows identical; mean collapses
