"""Hopper kernels: fused single-pass FPISA encode and decode.

Port of ``repro.kernels.fpisa_fused``; the CUDA source is
``repro_torch/csrc/fpisa_fused.cu`` (its header says what bounds the kernels
and how the design answers it). The functions here launch the kernels on
CUDA tensors and nothing else: they check device, dtype, shape, contiguity
and alignment, allocate the outputs, launch on the current stream and raise
if the launch was refused. ``kernels/ops.py`` dispatches between them and
the plain versions in ``kernels/ref.py``.

K1 in three modes:

  fused_encode_align : local mode, the TPU kernel's function. (R, B) packed
                       FP -> (man (R,B) int32 aligned to the LOCAL per-row
                       max exponent, bmax (R,) int32). One read of x, one
                       write of man (+ R ints of bmax).
  block_max          : exponent mode. x (k, R, B) leaf -> (R,) int32, the
                       block max exponent over the k workers. One read of x.
  encode_wire        : wire mode. x (k, R, B) leaf + the agreed (R,) bmax ->
                       the (R, B) wire plane: every element aligned to bmax
                       in one shift (pre-shifted), cast to the wire, summed
                       over the k workers in int32; int32 for 32- and 16-bit
                       wires, int8 for the 8-bit wire. One read of x, one
                       write of the plane.

The aggregation runs exponent mode, the MAX all-reduce, wire mode, the SUM
and K2: no shift, cast or fold is left between the kernels and the
collectives. Aligning to the agreed exponent in one shift gives the bits of
the local alignment followed by the residual shift ``arshift(man,
(global_bmax - bmax) + preshift)``, because arithmetic right shifts compose.
Both modes read a leaf of the format's dtype, or a bf16/fp16 leaf of the
fp32 format (``widens``), and widen it in registers.

K2:

  fused_decode       : (R, B) summed mantissas (int8/int16/int32 wire) +
                       (R,) block exponents -> (R, B) FP: upcast, exponent
                       repeat and renormalize in one pass, written in the
                       format's dtype or cast to ``out_dtype`` (fp32, fp16,
                       bf16; rounding to nearest even, as ``.to`` does).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.fpisa import PACKED_DTYPE
from repro_torch.kernels import _build

BLOCKS = (128, 256, 512)
FMT_CODES = {"fp32": 0, "fp16": 1, "bf16": 2}  # csrc/fpisa_fused.cu's fmt and dtype
DTYPE_CODES = {PACKED_DTYPE[name]: code for name, code in FMT_CODES.items()}
WIRE_DTYPES = (torch.int8, torch.int16, torch.int32)
WIRE_BITS = (8, 16, 32)
ALIGN = 16  # the kernels move words of up to 16 bytes

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library, with every entry point's C signature declared."""
    lib = _build.load("fpisa_fused")
    lib.fpisa_encode_align.argtypes = [_I, _P, _P, _P, _LL, _I, _P]
    lib.fpisa_encode_align.restype = _I
    lib.fpisa_block_max.argtypes = [_I, _I, _P, _P, _I, _LL, _I, _P]
    lib.fpisa_block_max.restype = _I
    lib.fpisa_encode_wire.argtypes = [_I, _I, _P, _P, _P, _I, _LL, _I, _I, _I, _P]
    lib.fpisa_encode_wire.restype = _I
    lib.fpisa_decode_fused.argtypes = [_I, _I, _P, _P, _P, _LL, _I, _I, _I, _P]
    lib.fpisa_decode_fused.restype = _I
    lib.fpisa_decode.argtypes = [_I, _P, _P, _P, _LL, _I, _I, _P]  # K5
    lib.fpisa_decode.restype = _I
    return lib


def widens(dtype: torch.dtype, fmt_name: str) -> bool:
    """Whether exponent and wire mode read a leaf of ``dtype`` for the
    format as it is: the format's own dtype, or fp16/bf16 into fp32 (exact
    casts, done in registers). Any other leaf is cast first
    (``fpisa.to_packed``)."""
    packed = PACKED_DTYPE[fmt_name]
    return dtype == packed or (packed == torch.float32
                               and dtype in (torch.float16, torch.bfloat16))


def wire_dtype(wire_bits: int) -> torch.dtype:
    """The wire plane's dtype: a 16-bit wire travels as int32 (F1)."""
    return torch.int8 if wire_bits == 8 else torch.int32


def check_plane(t: torch.Tensor, what: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what} must be a CUDA tensor, got device {t.device}")
    if t.dim() != 2 or t.shape[1] not in BLOCKS:
        raise ValueError(f"{what} must be (R, B) with B in {BLOCKS}, got "
                         f"shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def check_aligned(t: torch.Tensor, what: str) -> None:
    if t.data_ptr() % ALIGN:
        raise ValueError(f"{what} must start on a {ALIGN}-byte boundary (the kernel "
                         f"moves {ALIGN}-byte words), got address {t.data_ptr():#x}")


def check_stack(x: torch.Tensor, fmt_name: str) -> None:
    """``x`` must be a contiguous, aligned (k, R, B) CUDA stack of a dtype
    the format ``widens``."""
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got device {x.device}")
    if x.dim() != 3 or x.shape[0] < 1 or x.shape[2] not in BLOCKS:
        raise ValueError(f"x must be (k, R, B) with k >= 1 and B in {BLOCKS}, got "
                         f"shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    check_aligned(x, "x")
    if not widens(x.dtype, fmt_name):
        raise ValueError(f"fmt_name={fmt_name!r} reads {PACKED_DTYPE[fmt_name]} leaves"
                         f"{' (or fp16, bf16)' if fmt_name == 'fp32' else ''}, got {x.dtype}")


def check_row_vector(t: torch.Tensor, like: torch.Tensor, what: str, r: int | None = None) -> None:
    """``t`` must be a contiguous (R,) int32 tensor on ``like``'s device."""
    r = like.shape[0] if r is None else r
    if t.shape != (r,) or t.dtype != torch.int32 or t.device != like.device \
            or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous ({r},) int32 tensor on "
                         f"{like.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")


def fused_encode_align(x: torch.Tensor, fmt_name: str = "fp32"):
    """Local mode. x: (R, B) CUDA tensor in the format's dtype -> (man (R,B)
    int32 aligned to the LOCAL block max, bmax (R,) int32)."""
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


def block_max(x: torch.Tensor, fmt_name: str = "fp32") -> torch.Tensor:
    """Exponent mode. x: (k, R, B) CUDA leaf stack -> (R,) int32, the max
    exponent of each block over the k workers."""
    check_stack(x, fmt_name)
    k, r, b = x.shape
    bmax = torch.empty((r,), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    raise_on(_lib().fpisa_block_max(
        FMT_CODES[fmt_name], DTYPE_CODES[x.dtype], x.data_ptr(), bmax.data_ptr(), k, r, b,
        stream), "fpisa_block_max")
    return bmax


def encode_wire(x: torch.Tensor, bmax: torch.Tensor, preshift: int, wire_bits: int,
                fmt_name: str = "fp32") -> torch.Tensor:
    """Wire mode. x: (k, R, B) CUDA leaf stack + the agreed (R,) int32 block
    exponents -> the (R, B) wire plane (``wire_dtype(wire_bits)``): the k
    workers' aligned, pre-shifted, wire-cast mantissas summed in int32."""
    check_stack(x, fmt_name)
    k, r, b = x.shape
    check_row_vector(bmax, x, "bmax", r)
    if wire_bits not in WIRE_BITS:
        raise ValueError(f"wire_bits must be one of {WIRE_BITS}, got {wire_bits}")
    out = torch.empty((r, b), dtype=wire_dtype(wire_bits), device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    raise_on(_lib().fpisa_encode_wire(
        FMT_CODES[fmt_name], DTYPE_CODES[x.dtype], x.data_ptr(), bmax.data_ptr(),
        out.data_ptr(), k, r, b, int(preshift), int(wire_bits), stream), "fpisa_encode_wire")
    return out


def fused_decode(man_sum: torch.Tensor, bmax: torch.Tensor, preshift: int = 0,
                 fmt_name: str = "fp32", out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """(R, B) int8/int16/int32 CUDA summed mantissas + (R,) int32 block
    exponents -> (R, B) FP in ``out_dtype`` (fp32, fp16 or bf16; the
    format's dtype when None)."""
    check_plane(man_sum, "man_sum")
    check_aligned(man_sum, "man_sum")
    if man_sum.dtype not in WIRE_DTYPES:
        raise ValueError(f"man_sum must be one of {WIRE_DTYPES}, got {man_sum.dtype}")
    check_row_vector(bmax, man_sum, "bmax")
    out_dtype = PACKED_DTYPE[fmt_name] if out_dtype is None else out_dtype
    if out_dtype not in DTYPE_CODES:
        raise ValueError(f"out_dtype must be one of {tuple(DTYPE_CODES)}, got {out_dtype}")
    r, b = man_sum.shape
    out = torch.empty((r, b), dtype=out_dtype, device=man_sum.device)
    stream = torch.cuda.current_stream(man_sum.device).cuda_stream
    raise_on(_lib().fpisa_decode_fused(
        FMT_CODES[fmt_name], man_sum.element_size(), man_sum.data_ptr(),
        bmax.data_ptr(), out.data_ptr(), r, b, int(preshift), DTYPE_CODES[out_dtype],
        stream), "fpisa_decode_fused")
    return out
