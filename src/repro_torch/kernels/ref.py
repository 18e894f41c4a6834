"""Plain PyTorch versions of the Hopper kernels in this package.

Port of ``repro.kernels.ref``. They are the ground truth the kernels are
held against (on the card by ``chip_smoke.py``), the CPU path of
``kernels/ops.py``, and they reuse ``repro_torch.core.fpisa`` so the kernels
must match the core semantics bit for bit.

Every function takes the format explicitly and honours it. (The reference's
``ops.decode`` / ``ops.accum`` with ``use_pallas=False`` drop their
``fmt_name`` and so always decode fp32; the port does not copy that.)
``accum_ref`` returns the format's dtype, as the reference's does; the
kernel K6 emits float32 in its local mode, and ``ops.accum`` upcasts the
plain version to match it. ``accum_leaf_ref`` is K6's leaf mode: the same
sum over a leaf stack in its own dtype, cast back to it.
"""
from __future__ import annotations

import torch

from repro_torch.core import fpisa
from repro_torch.core import numerics as nx


def extract_ref(x: torch.Tensor, fmt: fpisa.FpFormat = fpisa.FP32):
    """Plain version of K3 ``fpisa_extract``: x (R,B) packed FP -> (exp (R,B)
    int32, man (R,B) int32, bmax (R,) int32), bmax the per-row (= per-block)
    max exponent, the quantity MAX-reduced across workers before alignment."""
    planes = fpisa.encode(x, fmt)
    return planes.exp, planes.man, planes.exp.amax(dim=-1)


def align_ref(exp: torch.Tensor, man: torch.Tensor, bmax: torch.Tensor,
              preshift: int, fmt: fpisa.FpFormat = fpisa.FP32):
    """Plain version of K4 ``fpisa_align``: shift the mantissas to the shared
    block exponent, (R,B) int32 -> (R,B) int32 (the format does not enter)."""
    return nx.arshift(man, (bmax[:, None] - exp) + preshift)


def decode_ref(man_sum: torch.Tensor, bmax: torch.Tensor, preshift: int,
               fmt: fpisa.FpFormat = fpisa.FP32):
    """Plain version of K5 ``fpisa_decode``: (R,B) int32 summed mantissas +
    (R,) block exponents -> (R,B) packed FP in the format's dtype."""
    e = (bmax[:, None] + preshift).expand(man_sum.shape)
    return fpisa.renormalize(fpisa.Planes(exp=e, man=man_sum), fmt)


def fused_encode_align_ref(x: torch.Tensor, fmt: fpisa.FpFormat = fpisa.FP32):
    """Plain version of ``fused_encode_align``: x (R,B) packed FP -> (man
    (R,B) int32 aligned to the LOCAL per-row max exponent, bmax (R,) int32).

    The residual cross-worker shift by ``(global_bmax - bmax) + preshift``
    composes exactly on top (arithmetic right shifts compose)."""
    exp, man, bmax = extract_ref(x, fmt)
    return align_ref(exp, man, bmax, 0, fmt), bmax


def block_max_ref(x: torch.Tensor, fmt: fpisa.FpFormat = fpisa.FP32):
    """Plain version of ``block_max`` (K1's exponent mode): x (k,R,B) leaf
    -> (R,) int32, each block's max exponent over the k workers (folded in
    order, worker 0 first). The leaf's cast to the format is exact (the
    format's dtype, or fp16/bf16 into fp32)."""
    exp = fpisa.encode(x, fmt).exp.amax(dim=-1)  # (k, R)
    out = exp[0]
    for w in range(1, exp.shape[0]):
        out = torch.maximum(out, exp[w])
    return out


def encode_wire_ref(x: torch.Tensor, bmax: torch.Tensor, preshift: int, wire_bits: int,
                    fmt: fpisa.FpFormat = fpisa.FP32):
    """Plain version of ``encode_wire`` (K1's wire mode): x (k,R,B) leaf +
    the agreed (R,) block exponents -> the (R,B) wire plane. Each worker's
    mantissas are aligned in one shift, ``arshift(man, (bmax - exp) +
    preshift)``, cast to the wire, summed in int32 worker 0 first, and the
    sum cast to the wire again; int32 for 32- and 16-bit wires (a 16-bit
    wire travels as int32), int8 for the 8-bit wire."""
    planes = fpisa.encode(x, fmt)
    man = nx.arshift(planes.man, (bmax[None, :, None] - planes.exp) + preshift)
    wire = {8: torch.int8, 16: torch.int16, 32: torch.int32}[wire_bits]
    total = man[0].to(wire).to(torch.int32)
    for w in range(1, man.shape[0]):
        total = total + man[w].to(wire).to(torch.int32)
    return total.to(wire).to(torch.int8 if wire_bits == 8 else torch.int32)


def fused_decode_ref(man_sum: torch.Tensor, bmax: torch.Tensor, preshift: int,
                     fmt: fpisa.FpFormat = fpisa.FP32, out_dtype: torch.dtype | None = None):
    """Plain version of ``fused_decode``: (R,B) summed mantissas of any wire
    dtype (int8/int16/int32) + (R,) block exponents -> (R,B) FP, in the
    format's dtype or cast to ``out_dtype``."""
    out = decode_ref(man_sum.to(torch.int32), bmax, preshift, fmt)
    return out if out_dtype is None else out.to(out_dtype)


def accum_ref(x: torch.Tensor, variant: str = "fpisa_a",
              fmt: fpisa.FpFormat = fpisa.FP32):
    """Plain version of K6 ``fpisa_accum``: sequential switch-order
    accumulation, x (W,R,B) packed FP -> (R,B) packed FP in the format's
    dtype (worker 0 first)."""
    return fpisa.fpisa_sum_sequential(x, fmt, variant=variant)


def accum_leaf_ref(x: torch.Tensor, variant: str = "fpisa_a",
                   fmt: fpisa.FpFormat = fpisa.FP32):
    """Plain version of K6's leaf mode ``fpisa_accum_leaf``: x (W,...) leaf
    stack of a dtype the format widens exactly (its own dtype, or fp16/bf16
    under fp32) -> (...) in that dtype, worker 0 first: the reference's
    ``fpisa_sum_sequential`` of the stack, then the cast to the leaf's
    dtype (rounding to nearest even)."""
    return fpisa.fpisa_sum_sequential(x, fmt, variant=variant).to(x.dtype)
