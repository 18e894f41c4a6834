"""Public wrappers for the FPISA kernels: dispatch by tensor device.

A CUDA tensor launches the Hopper kernel (``kernels/fpisa_fused.py``) or
raises; a CPU tensor takes the kernel's plain version (``kernels/ref.py``),
and only because it lies on the CPU. Nothing catches a failed build or
launch to fall back to the plain version.

Each wrapper keeps a plain integer count of its kernel launches
(``encode_align.launches``, ``decode_fused.launches``), incremented where
the kernel is launched and nowhere else, so a run can show that it went
through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.core import fpisa
from repro_torch.kernels import fpisa_fused, ref


def _check_format(x: torch.Tensor, fmt_name: str) -> None:
    if x.dim() != 2:
        raise ValueError(f"expected an (R, B) plane, got shape {tuple(x.shape)}")
    if x.dtype != fpisa.PACKED_DTYPE[fmt_name]:
        raise ValueError(f"fmt_name={fmt_name!r} takes "
                         f"{fpisa.PACKED_DTYPE[fmt_name]}, got {x.dtype}")


def encode_align(x: torch.Tensor, fmt_name: str = "fp32"):
    """Fused single-pass extract + align to the LOCAL block max:
    x (R, B) packed FP -> (man (R, B) int32, bmax (R,) int32)."""
    _check_format(x, fmt_name)
    if x.is_cuda:
        out = fpisa_fused.fused_encode_align(x, fmt_name)
        encode_align.launches += 1
        return out
    return ref.fused_encode_align_ref(x, fpisa.FORMATS[fmt_name])


def decode_fused(man_sum: torch.Tensor, bmax: torch.Tensor, preshift: int = 0,
                 fmt_name: str = "fp32") -> torch.Tensor:
    """Fused decode accepting narrow wire dtypes (int8/int16/int32):
    (R, B) summed mantissas + (R,) block exponents -> (R, B) packed FP."""
    if man_sum.is_cuda:
        out = fpisa_fused.fused_decode(man_sum, bmax, preshift, fmt_name)
        decode_fused.launches += 1
        return out
    return ref.fused_decode_ref(man_sum, bmax, preshift, fpisa.FORMATS[fmt_name])


encode_align.launches = 0
decode_fused.launches = 0
