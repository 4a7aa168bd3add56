"""Checks every CUDA wrapper makes before handing pointers to a kernel."""
from __future__ import annotations

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


def current_stream(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
