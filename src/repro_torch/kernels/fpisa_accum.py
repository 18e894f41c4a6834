"""Hopper kernel: sequential switch-arrival FPISA accumulation over a worker
axis, in two modes.

Port of ``repro.kernels.fpisa_accum``; the CUDA source is
``repro_torch/csrc/fpisa_accum.cu`` (its header says what bounds the kernel
and how the design answers it: 16-byte words, every worker's words loaded
before the first add, a branch-free add). The functions here launch the
kernel on CUDA tensors and nothing else: they check device, dtype, shape
and contiguity, allocate the output, launch on the current stream and raise
if the launch was refused. ``kernels/ops.py`` dispatches between them and
``kernels/ref.py``'s plain versions.

  fpisa_accum      : local mode, the TPU kernel's function. (W, R, B) packed
                     FP, worker 0 first -> (R, B) float32, the format's
                     renormalized value upcast exactly (the TPU kernel emits
                     float32 whatever the format).
  fpisa_accum_leaf : leaf mode. (W, ...) leaf stack in its own dtype D, which
                     the format widens exactly (the format's dtype, or
                     fp16/bf16 under fp32) -> (...) in D, the format's value
                     rounded to nearest even as ``.to(D)`` rounds: the
                     fpisa_seq paths' sum, with the casts around it taken in.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.fpisa import PACKED_DTYPE
from repro_torch.kernels import _build
from repro_torch.kernels.fpisa_fused import DTYPE_CODES, FMT_CODES, raise_on, widens

VARIANTS = {"fpisa_a": 0, "full": 1}  # csrc/fpisa_accum.cu's variant

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fpisa_accum")
    lib.fpisa_accum.argtypes = [_I, _I, _P, _P, _LL, _I, _P]
    lib.fpisa_accum.restype = _I
    lib.fpisa_accum_leaf.argtypes = [_I, _I, _I, _P, _P, _LL, _I, _P]
    lib.fpisa_accum_leaf.restype = _I
    return lib


def _check(x: torch.Tensor, variant: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {tuple(VARIANTS)}, got {variant!r}")


def fpisa_accum(x: torch.Tensor, variant: str = "fpisa_a",
                fmt_name: str = "fp32") -> torch.Tensor:
    """Local mode. x: (W, R, B) contiguous CUDA tensor in the format's dtype
    -> (R, B) float32 switch-order FPISA aggregate."""
    if x.dim() != 3 or x.shape[0] < 1:
        raise ValueError(f"x must be (W, R, B) with W >= 1, got shape {tuple(x.shape)}")
    _check(x, variant)
    if x.dtype != PACKED_DTYPE[fmt_name]:
        raise ValueError(f"x must be {PACKED_DTYPE[fmt_name]} for "
                         f"fmt_name={fmt_name!r}, got {x.dtype}")
    w, r, b = x.shape
    out = torch.empty((r, b), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    raise_on(_lib().fpisa_accum(
        FMT_CODES[fmt_name], VARIANTS[variant], x.data_ptr(), out.data_ptr(), r * b, w,
        stream), "fpisa_accum")
    return out


def fpisa_accum_leaf(x: torch.Tensor, variant: str = "fpisa_a",
                     fmt_name: str = "fp32") -> torch.Tensor:
    """Leaf mode. x: (W, ...) contiguous CUDA leaf stack, worker 0 first, of
    a dtype the format widens -> (...) in x's dtype."""
    if x.dim() < 1 or x.shape[0] < 1:
        raise ValueError(f"x must be (W, ...) with W >= 1, got shape {tuple(x.shape)}")
    _check(x, variant)
    if not widens(x.dtype, fmt_name):
        raise ValueError(f"fmt_name={fmt_name!r} reads {PACKED_DTYPE[fmt_name]} leaves"
                         f"{' (or fp16, bf16)' if fmt_name == 'fp32' else ''}, got {x.dtype}")
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    raise_on(_lib().fpisa_accum_leaf(
        FMT_CODES[fmt_name], DTYPE_CODES[x.dtype], VARIANTS[variant], x.data_ptr(),
        out.data_ptr(), out.numel(), x.shape[0], stream), "fpisa_accum_leaf")
    return out
