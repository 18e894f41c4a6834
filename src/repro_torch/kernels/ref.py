"""Plain PyTorch versions of the Hopper kernels in this package.

Port of ``repro.kernels.ref`` (the two oracles on the aggregation path).
They are the ground truth the kernels are held against (on the card by
``chip_smoke.py``), the CPU path of ``kernels/ops.py``, and they reuse
``repro_torch.core.fpisa`` so the kernels must match the core semantics bit
for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core import fpisa
from repro_torch.core import numerics as nx


def fused_encode_align_ref(x: torch.Tensor, fmt: fpisa.FpFormat = fpisa.FP32):
    """Plain version of ``fused_encode_align``: x (R,B) packed FP -> (man
    (R,B) int32 aligned to the LOCAL per-row max exponent, bmax (R,) int32).

    The residual cross-worker shift by ``(global_bmax - bmax) + preshift``
    composes exactly on top (arithmetic right shifts compose)."""
    planes = fpisa.encode(x, fmt)
    bmax = planes.exp.amax(dim=-1)
    return nx.arshift(planes.man, bmax[:, None] - planes.exp), bmax


def fused_decode_ref(man_sum: torch.Tensor, bmax: torch.Tensor, preshift: int,
                     fmt: fpisa.FpFormat = fpisa.FP32):
    """Plain version of ``fused_decode``: (R,B) summed mantissas of any wire
    dtype (int8/int16/int32) + (R,) block exponents -> (R,B) packed FP."""
    e = (bmax[:, None] + preshift).expand(man_sum.shape)
    return fpisa.renormalize(fpisa.Planes(exp=e, man=man_sum.to(torch.int32)), fmt)
