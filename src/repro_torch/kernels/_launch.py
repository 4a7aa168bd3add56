"""Checks every CUDA wrapper makes before handing pointers to a kernel, the
run bounds the sorted-stream kernels read, and the node count of a captured
CUDA graph."""
from __future__ import annotations

import ctypes

import torch

from ._build import INDEX_CODES, VALUE_CODES


def check_cuda_operands(name: str, *tensors) -> None:
    """Every operand (``None`` skipped) lies on one CUDA device and is
    contiguous: the kernels take raw pointers and assume dense strides."""
    ts = [t for t in tensors if t is not None]
    dev = ts[0].device
    for t in ts:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: operands must lie on one CUDA device, got "
                             f"{[str(u.device) for u in ts]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def no_grad_operands(name: str, *tensors) -> None:
    """Raise where autograd would need this kernel's gradient: grad mode on
    and an operand (``None`` skipped) that requires grad. Only ``bsr_spmm``
    has a backward on the card; every other kernel writes into a fresh
    tensor through a raw pointer, which would cut the graph without a word,
    so its launch refuses instead."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an operand requires grad; "
            f"run this product under use_backend('plain') (or torch.no_grad()) to train "
            f"through it")


def checked_x(name: str, x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` in f32, once it has been checked to be a contiguous vector on
    ``device``, the device of the operands a cached record checked."""
    if x.dtype is not torch.float32:
        x = x.float()
    if x.device != device or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"{name}: operands must lie on one CUDA device, and x must be "
                         f"a contiguous vector on {device}, got {x.device}")
    return x


def value_code(name: str, dtype: torch.dtype) -> int:
    code = VALUE_CODES.get(str(dtype).replace("torch.", ""))
    if code is None:
        raise TypeError(f"{name}: value dtype {dtype} is not one of {sorted(VALUE_CODES)}")
    return code


def index_code(name: str, dtype: torch.dtype) -> int:
    code = INDEX_CODES.get(str(dtype).replace("torch.", ""))
    if code is None:
        raise TypeError(f"{name}: index dtype {dtype} is not one of {sorted(INDEX_CODES)}")
    return code


def segment_starts(keys: torch.Tensor, nseg: int) -> torch.Tensor:
    """``starts (nseg + 1,)`` int32: segment ``s`` of the sorted ``keys``
    is ``[starts[s], starts[s + 1])`` (keys ``>= nseg`` lie past the end).
    The kernels that walk a run of entries or blocks per output window
    read these bounds."""
    bounds = torch.arange(nseg + 1, dtype=keys.dtype, device=keys.device)
    return torch.searchsorted(keys, bounds).to(torch.int32)


def current_stream(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device`` (a CUDA
    device with its index), without building a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def graph_nodes(graph: int) -> int:
    """The node count of a captured ``cudaGraph_t`` (``CUDAGraph.raw_cuda_graph()``
    of a graph captured with ``keep_graph=True``, before or after instantiation)."""
    from ._build import library

    lib = library()
    n = ctypes.c_longlong(0)
    lib.call("repro_graph_nodes", graph, ctypes.byref(n))
    return int(n.value)
