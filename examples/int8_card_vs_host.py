"""Where the int8 compressed all-reduce departs between the card and the
host: the chunk scales or the codes.

    python examples/int8_card_vs_host.py        # needs a CUDA device

For random vectors of 2^11, 2^20 and 2^22 f32 it quantises on the card and
on the host with ``distributed.compression._quant`` (the absmax divided by
a device tensor) and with the same quantiser dividing by the Python scalar
127.0, which ATen's CUDA division turns into a product with the
reciprocal. Each line counts the chunks whose scale differs, the codes
that differ, and how many of those lie in chunks whose scale agrees; then
the whole ``CompressedAllReduce`` over ``PartMesh.on("cuda", parts=4)``
against the host's, bit for bit.
"""
import numpy as np
import torch

from repro_torch.core import PartMesh
from repro_torch.distributed.compression import CompressedAllReduce, _quant


def scalar_quant(x, chunk=256):
    """``_quant`` with the scale divided by the host scalar 127.0."""
    n = x.shape[0]
    xp = torch.zeros((-(-n // chunk) * chunk,), dtype=x.dtype, device=x.device)
    xp[:n] = x
    xp = xp.reshape(-1, chunk)
    scale = torch.amax(torch.abs(xp), dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(xp / torch.clamp(scale, min=1e-12)), -127, 127).to(torch.int8)
    return q, scale


def main():
    if not torch.cuda.is_available():
        raise SystemExit("int8_card_vs_host: needs a CUDA device")
    for n, chunk in ((2048, 64), (1 << 20, 256), (1 << 22, 256)):
        x = torch.from_numpy(np.random.default_rng(n).standard_normal(n).astype(np.float32))
        for name, quant in (("scalar 127.0", scalar_quant), ("device tensor", _quant)):
            qh, sh = quant(x, chunk)
            qd, sd = (t.cpu() for t in quant(x.cuda(), chunk))
            same = (sd == sh).flatten()
            bad = qd != qh
            print(f"[quant, {name}] n={n} chunk={chunk} scale_diff_chunks={int((~same).sum())} "
                  f"of {same.numel()} code_diffs={int(bad.sum())} "
                  f"code_diffs_where_scales_agree={int(bad[same].sum())}", flush=True)
        vecs = np.random.default_rng(n).standard_normal((4, n)).astype(np.float32)
        host = CompressedAllReduce(PartMesh.on("cpu", parts=4), chunk=chunk)
        card = CompressedAllReduce(PartMesh.on("cuda", parts=4), chunk=chunk)
        vp = torch.zeros(4, host.padded_len(n))
        vp[:, :n] = torch.from_numpy(vecs)
        m_h, e_h = host(vp, host.init_error(n))
        m_d, e_d = card(vp.cuda(), card.init_error(n))
        print(f"[all-reduce] n={n} chunk={chunk} mean_equal={torch.equal(m_d.cpu(), m_h)} "
              f"residual_equal={torch.equal(e_d.cpu(), e_h)}", flush=True)


if __name__ == "__main__":
    main()
