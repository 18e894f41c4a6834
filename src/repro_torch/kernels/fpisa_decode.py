"""Hopper kernel: the two-pass FPISA decode (delayed renormalization).

Port of ``repro.kernels.fpisa_decode``; the CUDA entry point is
``fpisa_decode`` in ``repro_torch/csrc/fpisa_fused.cu``, which runs K2's
decode kernel at int32 input. ``fpisa_decode`` launches it on CUDA tensors
and nothing else (checks, output allocation, launch on the
current stream, raise if refused); ``kernels/ops.py`` dispatches between it
and ``kernels/ref.py::decode_ref``.

  fpisa_decode : (R, B) int32 summed mantissas + (R,) int32 block exponents
                 -> (R, B) packed FP in the format's dtype.

It is ``fpisa_fused.fused_decode`` restricted to the int32 input the TPU
kernel takes.
"""
from __future__ import annotations

import torch

from repro_torch.core.fpisa import PACKED_DTYPE
from repro_torch.kernels.fpisa_fused import (
    FMT_CODES, _lib, check_aligned, check_plane, check_row_vector, raise_on,
)


def fpisa_decode(man_sum: torch.Tensor, bmax: torch.Tensor, preshift: int = 0,
                 fmt_name: str = "fp32") -> torch.Tensor:
    """(R, B) int32 CUDA summed mantissas + (R,) int32 block exponents ->
    (R, B) packed FP in the format's dtype."""
    check_plane(man_sum, "man_sum")
    check_aligned(man_sum, "man_sum")
    if man_sum.dtype != torch.int32:
        raise ValueError(f"man_sum must be int32, got {man_sum.dtype}")
    check_row_vector(bmax, man_sum, "bmax")
    r, b = man_sum.shape
    out = torch.empty((r, b), dtype=PACKED_DTYPE[fmt_name], device=man_sum.device)
    stream = torch.cuda.current_stream(man_sum.device).cuda_stream
    raise_on(_lib().fpisa_decode(
        FMT_CODES[fmt_name], man_sum.data_ptr(), bmax.data_ptr(), out.data_ptr(),
        r, b, int(preshift), stream), "fpisa_decode")
    return out
