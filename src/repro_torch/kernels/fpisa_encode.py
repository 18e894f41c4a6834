"""Hopper kernels: the two-pass FPISA encode, extract then align.

Port of ``repro.kernels.fpisa_encode``; the CUDA source is
``repro_torch/csrc/fpisa_encode.cu`` (its header says what bounds the
kernels and how the design answers it). The functions here launch the
kernels on CUDA tensors and nothing else: they check device, dtype, shape
and contiguity, allocate the outputs, launch on the current stream and raise
if the launch was refused. ``kernels/ops.py`` dispatches between them and
the plain versions in ``kernels/ref.py``.

  fpisa_extract : (R, B) packed FP -> (exp (R,B) int32, man (R,B) int32,
                  bmax (R,) int32): one read of x, two plane writes.
  fpisa_align   : (exp, man (R,B) int32, bmax (R,) int32, preshift) ->
                  arshift(man, (bmax - exp) + preshift), (R,B) int32.

The fused kernel ``fpisa_fused.fused_encode_align`` is these two in one pass
against the local block max.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.fpisa import PACKED_DTYPE
from repro_torch.kernels import _build
from repro_torch.kernels.fpisa_fused import FMT_CODES, check_plane, check_row_vector, raise_on

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library, with every entry point's C signature declared."""
    lib = _build.load("fpisa_encode")
    lib.fpisa_extract.argtypes = [_I, _P, _P, _P, _P, _LL, _I, _P]
    lib.fpisa_extract.restype = _I
    lib.fpisa_align.argtypes = [_P, _P, _P, _P, _LL, _I, _I, _P]
    lib.fpisa_align.restype = _I
    return lib


def fpisa_extract(x: torch.Tensor, fmt_name: str = "fp32"):
    """x: (R, B) CUDA tensor in the format's dtype -> (exp (R,B) int32,
    man (R,B) int32, bmax (R,) int32)."""
    check_plane(x, "x")
    if x.dtype != PACKED_DTYPE[fmt_name]:
        raise ValueError(f"x must be {PACKED_DTYPE[fmt_name]} for "
                         f"fmt_name={fmt_name!r}, got {x.dtype}")
    r, b = x.shape
    exp = torch.empty((r, b), dtype=torch.int32, device=x.device)
    man = torch.empty((r, b), dtype=torch.int32, device=x.device)
    bmax = torch.empty((r,), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    raise_on(_lib().fpisa_extract(
        FMT_CODES[fmt_name], x.data_ptr(), exp.data_ptr(), man.data_ptr(),
        bmax.data_ptr(), r, b, stream), "fpisa_extract")
    return exp, man, bmax


def fpisa_align(exp: torch.Tensor, man: torch.Tensor, bmax: torch.Tensor,
                preshift: int = 0) -> torch.Tensor:
    """(R, B) int32 CUDA exponent and mantissa planes + (R,) int32 block
    exponents -> (R, B) int32 mantissas aligned to the block exponent."""
    check_plane(man, "man")
    if man.dtype != torch.int32 or exp.dtype != torch.int32:
        raise ValueError(f"exp and man must be int32, got {exp.dtype} and {man.dtype}")
    if exp.shape != man.shape or exp.device != man.device or not exp.is_contiguous():
        raise ValueError(f"exp must be a contiguous {tuple(man.shape)} plane on "
                         f"{man.device}, got {tuple(exp.shape)} on {exp.device}")
    check_row_vector(bmax, man, "bmax")
    r, b = man.shape
    out = torch.empty((r, b), dtype=torch.int32, device=man.device)
    stream = torch.cuda.current_stream(man.device).cuda_stream
    raise_on(_lib().fpisa_align(
        exp.data_ptr(), man.data_ptr(), bmax.data_ptr(), out.data_ptr(), r, b,
        int(preshift), stream), "fpisa_align")
    return out
