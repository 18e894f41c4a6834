"""Hopper kernels: fused single-pass FPISA encode->align and decode.

Port of ``repro.kernels.fpisa_fused``; the CUDA source is
``repro_torch/csrc/fpisa_fused.cu`` (its header says what bounds the kernels
and how the design answers it). The two functions here launch the kernels on
CUDA tensors and nothing else: they check device, dtype, shape and
contiguity, allocate the outputs, launch on the current stream and raise if
the launch was refused. ``kernels/ops.py`` dispatches between them and the
plain versions in ``kernels/ref.py``.

  fused_encode_align : (R, B) packed FP -> (man (R,B) int32 aligned to the
                       LOCAL per-row max exponent, bmax (R,) int32). One read
                       of x, one write of man (+ R ints of bmax).
  fused_decode       : (R, B) summed mantissas (int8/int16/int32 wire) +
                       (R,) block exponents -> (R, B) packed FP: upcast,
                       exponent repeat and renormalize in one pass.

Alignment factorization (as in the reference): the fused encode aligns to
the local block max; the caller finishes with ``arshift(man, (global_bmax -
bmax) + preshift)`` after the exponent MAX all-reduce, which is bit-identical
to aligning to the global exponent directly, because arithmetic right shifts
compose.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.fpisa import PACKED_DTYPE
from repro_torch.kernels import _build

BLOCKS = (128, 256, 512)
FMT_CODES = {"fp32": 0, "fp16": 1, "bf16": 2}  # csrc/fpisa_fused.cu's fmt
WIRE_DTYPES = (torch.int8, torch.int16, torch.int32)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library, with every entry point's C signature declared."""
    lib = _build.load("fpisa_fused")
    lib.fpisa_encode_align.argtypes = [_I, _P, _P, _P, _LL, _I, _P]
    lib.fpisa_encode_align.restype = _I
    lib.fpisa_decode_fused.argtypes = [_I, _I, _P, _P, _P, _LL, _I, _I, _P]
    lib.fpisa_decode_fused.restype = _I
    lib.fpisa_decode.argtypes = [_I, _P, _P, _P, _LL, _I, _I, _P]  # K5
    lib.fpisa_decode.restype = _I
    return lib


def check_plane(t: torch.Tensor, what: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what} must be a CUDA tensor, got device {t.device}")
    if t.dim() != 2 or t.shape[1] not in BLOCKS:
        raise ValueError(f"{what} must be (R, B) with B in {BLOCKS}, got "
                         f"shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def check_row_vector(t: torch.Tensor, like: torch.Tensor, what: str) -> None:
    """``t`` must be a contiguous (R,) int32 tensor on ``like``'s device."""
    r = like.shape[0]
    if t.shape != (r,) or t.dtype != torch.int32 or t.device != like.device \
            or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous ({r},) int32 tensor on "
                         f"{like.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")


def fused_encode_align(x: torch.Tensor, fmt_name: str = "fp32"):
    """x: (R, B) CUDA tensor in the format's dtype -> (man (R,B) int32
    aligned to the LOCAL block max, bmax (R,) int32)."""
    check_plane(x, "x")
    if x.dtype != PACKED_DTYPE[fmt_name]:
        raise ValueError(f"x must be {PACKED_DTYPE[fmt_name]} for "
                         f"fmt_name={fmt_name!r}, got {x.dtype}")
    r, b = x.shape
    man = torch.empty((r, b), dtype=torch.int32, device=x.device)
    bmax = torch.empty((r,), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    raise_on(_lib().fpisa_encode_align(
        FMT_CODES[fmt_name], x.data_ptr(), man.data_ptr(), bmax.data_ptr(),
        r, b, stream), "fpisa_encode_align")
    return man, bmax


def fused_decode(man_sum: torch.Tensor, bmax: torch.Tensor, preshift: int = 0,
                 fmt_name: str = "fp32") -> torch.Tensor:
    """(R, B) int8/int16/int32 CUDA summed mantissas + (R,) int32 block
    exponents -> (R, B) packed FP in the format's dtype."""
    check_plane(man_sum, "man_sum")
    if man_sum.dtype not in WIRE_DTYPES:
        raise ValueError(f"man_sum must be one of {WIRE_DTYPES}, got {man_sum.dtype}")
    check_row_vector(bmax, man_sum, "bmax")
    r, b = man_sum.shape
    out = torch.empty((r, b), dtype=PACKED_DTYPE[fmt_name], device=man_sum.device)
    stream = torch.cuda.current_stream(man_sum.device).cuda_stream
    raise_on(_lib().fpisa_decode_fused(
        FMT_CODES[fmt_name], man_sum.element_size(), man_sum.data_ptr(),
        bmax.data_ptr(), out.data_ptr(), r, b, int(preshift), stream),
        "fpisa_decode_fused")
    return out
