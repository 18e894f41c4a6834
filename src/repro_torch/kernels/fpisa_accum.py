"""Hopper kernel: sequential switch-arrival FPISA accumulation over a worker
axis.

Port of ``repro.kernels.fpisa_accum``; the CUDA source is
``repro_torch/csrc/fpisa_accum.cu`` (one thread per element column, the
accumulator in registers, a loop over the workers in arrival order).
``fpisa_accum`` launches the kernel on CUDA tensors and nothing else;
``kernels/ops.py`` dispatches between it and ``kernels/ref.py::accum_ref``.

  fpisa_accum : (W, R, B) packed FP, worker 0 first -> (R, B) float32, the
                format's renormalized value upcast exactly (the TPU kernel
                emits float32 whatever the format).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.fpisa import PACKED_DTYPE
from repro_torch.kernels import _build
from repro_torch.kernels.fpisa_fused import FMT_CODES, raise_on

VARIANTS = {"fpisa_a": 0, "full": 1}  # csrc/fpisa_accum.cu's variant

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fpisa_accum")
    lib.fpisa_accum.argtypes = [_I, _I, _P, _P, _LL, _I, _P]
    lib.fpisa_accum.restype = _I
    return lib


def fpisa_accum(x: torch.Tensor, variant: str = "fpisa_a",
                fmt_name: str = "fp32") -> torch.Tensor:
    """x: (W, R, B) contiguous CUDA tensor in the format's dtype -> (R, B)
    float32 switch-order FPISA aggregate."""
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got device {x.device}")
    if x.dim() != 3 or x.shape[0] < 1:
        raise ValueError(f"x must be (W, R, B) with W >= 1, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.dtype != PACKED_DTYPE[fmt_name]:
        raise ValueError(f"x must be {PACKED_DTYPE[fmt_name]} for "
                         f"fmt_name={fmt_name!r}, got {x.dtype}")
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {tuple(VARIANTS)}, got {variant!r}")
    w, r, b = x.shape
    out = torch.empty((r, b), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    raise_on(_lib().fpisa_accum(
        FMT_CODES[fmt_name], VARIANTS[variant], x.data_ptr(), out.data_ptr(), r * b, w,
        stream), "fpisa_accum")
    return out
