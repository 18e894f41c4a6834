"""Public wrappers for the FPISA kernels: dispatch by tensor device.

A CUDA tensor launches the Hopper kernel (``kernels/fpisa_fused.py``,
``fpisa_encode.py``, ``fpisa_decode.py``, ``fpisa_accum.py``) or raises; a
CPU tensor takes the kernel's plain version (``kernels/ref.py``), and only
because it lies on the CPU. Nothing catches a failed build or
launch to fall back to the plain version.

Each wrapper keeps a plain integer count of its kernel launches
(``encode_align.launches``, ``decode_fused.launches``, ``extract.launches``,
...), incremented where the kernel is launched and nowhere else, so a run
can show that it went through the kernels. K1's three modes are three
wrappers, each with its own count: ``encode_align`` (local mode),
``block_max`` (exponent mode) and ``encode_wire`` (wire mode). K2's
``decode_fused`` also counts its launches by mode in
``decode_fused.modes``: ``"format"`` where it writes the format's dtype,
``"leaf"`` where it writes another (the leaf's cast taken in). K6 has two
modes, ``accum`` (local: the TPU kernel's float32 out) and ``accum_leaf``
(leaf: a leaf stack in its own dtype, that dtype out); both count in
``accum.launches`` and, by mode, in ``accum.launches_by_mode``.
``chunked_attention`` (A1, the
port's kernel for the reference's ``jnp`` chunked attention) counts on its
two launch functions in ``kernels/attention.py``:
``attention_forward.launches`` and ``attention_backward.launches`` (one per
backward: dQ, then dK/dV).

The CPU path passes the format through to the plain version (the
reference's ``use_pallas=False`` paths of ``decode`` / ``accum`` drop it);
``accum`` returns float32 on both devices, as the TPU kernel does.
"""
from __future__ import annotations

import torch

from repro_torch.core import fpisa
from repro_torch.kernels import fpisa_accum, fpisa_decode, fpisa_encode, fpisa_fused, ref
from repro_torch.kernels.attention import ChunkedAttention, chunked_attention_ref


def _check_format(x: torch.Tensor, fmt_name: str) -> None:
    if x.dim() != 2:
        raise ValueError(f"expected an (R, B) plane, got shape {tuple(x.shape)}")
    if x.dtype != fpisa.PACKED_DTYPE[fmt_name]:
        raise ValueError(f"fmt_name={fmt_name!r} takes "
                         f"{fpisa.PACKED_DTYPE[fmt_name]}, got {x.dtype}")


def encode_align(x: torch.Tensor, fmt_name: str = "fp32"):
    """K1's local mode, fused single-pass extract + align to the LOCAL
    block max: x (R, B) packed FP -> (man (R, B) int32, bmax (R,) int32)."""
    _check_format(x, fmt_name)
    if x.is_cuda:
        out = fpisa_fused.fused_encode_align(x, fmt_name)
        encode_align.launches += 1
        return out
    return ref.fused_encode_align_ref(x, fpisa.FORMATS[fmt_name])


def _check_stack(x: torch.Tensor, fmt_name: str) -> None:
    if x.dim() != 3:
        raise ValueError(f"expected a (k, R, B) stack, got shape {tuple(x.shape)}")
    if not fpisa_fused.widens(x.dtype, fmt_name):
        raise ValueError(f"fmt_name={fmt_name!r} reads {fpisa.PACKED_DTYPE[fmt_name]} "
                         f"leaves (fp32 also fp16 and bf16), got {x.dtype}")


def block_max(x: torch.Tensor, fmt_name: str = "fp32") -> torch.Tensor:
    """K1's exponent mode: x (k, R, B) leaf, k workers' rows -> (R,) int32,
    each block's max exponent over the k workers."""
    _check_stack(x, fmt_name)
    if x.is_cuda:
        out = fpisa_fused.block_max(x, fmt_name)
        block_max.launches += 1
        return out
    return ref.block_max_ref(x, fpisa.FORMATS[fmt_name])


def encode_wire(x: torch.Tensor, bmax: torch.Tensor, preshift: int, wire_bits: int,
                fmt_name: str = "fp32") -> torch.Tensor:
    """K1's wire mode: x (k, R, B) leaf + the agreed (R,) block exponents ->
    the (R, B) wire plane (int32; int8 for an 8-bit wire): aligned in one
    shift, pre-shifted, wire-cast and summed over the k workers."""
    _check_stack(x, fmt_name)
    if x.is_cuda:
        out = fpisa_fused.encode_wire(x, bmax, preshift, wire_bits, fmt_name)
        encode_wire.launches += 1
        return out
    return ref.encode_wire_ref(x, bmax, preshift, wire_bits, fpisa.FORMATS[fmt_name])


def decode_fused(man_sum: torch.Tensor, bmax: torch.Tensor, preshift: int = 0,
                 fmt_name: str = "fp32", out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Fused decode accepting narrow wire dtypes (int8/int16/int32):
    (R, B) summed mantissas + (R,) block exponents -> (R, B) FP in the
    format's dtype, or cast to ``out_dtype``."""
    if man_sum.is_cuda:
        out = fpisa_fused.fused_decode(man_sum, bmax, preshift, fmt_name, out_dtype)
        decode_fused.launches += 1
        decode_fused.modes["format" if out.dtype == fpisa.PACKED_DTYPE[fmt_name]
                           else "leaf"] += 1
        return out
    return ref.fused_decode_ref(man_sum, bmax, preshift, fpisa.FORMATS[fmt_name], out_dtype)


def extract(x: torch.Tensor, fmt_name: str = "fp32"):
    """Two-pass encode, first pass (K3): x (R, B) packed FP -> (exp (R, B)
    int32, man (R, B) int32, bmax (R,) int32)."""
    _check_format(x, fmt_name)
    if x.is_cuda:
        out = fpisa_encode.fpisa_extract(x, fmt_name)
        extract.launches += 1
        return out
    return ref.extract_ref(x, fpisa.FORMATS[fmt_name])


def align(exp: torch.Tensor, man: torch.Tensor, bmax: torch.Tensor,
          preshift: int = 0) -> torch.Tensor:
    """Two-pass encode, second pass (K4): (R, B) int32 planes + (R,) block
    exponents -> (R, B) int32 mantissas aligned to them, pre-shifted."""
    if man.is_cuda:
        out = fpisa_encode.fpisa_align(exp, man, bmax, preshift)
        align.launches += 1
        return out
    return ref.align_ref(exp, man, bmax, preshift)


def decode(man_sum: torch.Tensor, bmax: torch.Tensor, preshift: int = 0,
           fmt_name: str = "fp32") -> torch.Tensor:
    """Two-pass decode (K5): (R, B) int32 summed mantissas + (R,) block
    exponents -> (R, B) packed FP in the format's dtype."""
    if man_sum.is_cuda:
        out = fpisa_decode.fpisa_decode(man_sum, bmax, preshift, fmt_name)
        decode.launches += 1
        return out
    return ref.decode_ref(man_sum, bmax, preshift, fpisa.FORMATS[fmt_name])


def accum(x: torch.Tensor, variant: str = "fpisa_a", fmt_name: str = "fp32") -> torch.Tensor:
    """Switch-arrival accumulation (K6's local mode): x (W, R, B) packed FP,
    worker 0 first -> (R, B) float32 (the format's value, upcast exactly)."""
    if x.dim() != 3 or x.dtype != fpisa.PACKED_DTYPE[fmt_name]:
        raise ValueError(f"expected a (W, R, B) stack of {fpisa.PACKED_DTYPE[fmt_name]} "
                         f"for fmt_name={fmt_name!r}, got {x.dtype}{tuple(x.shape)}")
    if x.is_cuda:
        out = fpisa_accum.fpisa_accum(x, variant, fmt_name)
        accum.launches += 1
        accum.launches_by_mode["local"] += 1
        return out
    return ref.accum_ref(x, variant, fpisa.FORMATS[fmt_name]).to(torch.float32)


def accum_leaf(x: torch.Tensor, variant: str = "fpisa_a", fmt_name: str = "fp32") -> torch.Tensor:
    """K6's leaf mode: x (W, ...) leaf stack in its own dtype, which the
    format widens exactly (the format's dtype, or fp16/bf16 under fp32),
    worker 0 first -> (...) in that dtype (the format's value rounded to
    nearest even). Its launches count in ``accum.launches``."""
    if x.dim() < 1 or not fpisa_fused.widens(x.dtype, fmt_name):
        raise ValueError(f"expected a (W, ...) stack of a dtype fmt_name={fmt_name!r} "
                         f"widens, got {x.dtype}{tuple(x.shape)}")
    if x.is_cuda:
        out = fpisa_accum.fpisa_accum_leaf(x, variant, fmt_name)
        accum.launches += 1
        accum.launches_by_mode["leaf"] += 1
        return out
    return ref.accum_leaf_ref(x, variant, fpisa.FORMATS[fmt_name])


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                      cq: int, ck: int, remat_step: bool = True,
                      scale: float | None = None) -> torch.Tensor:
    """A1: the reference's chunked attention at chunk sizes (cq, ck), q (B,
    S, H, hd), k, v (B, Sk, K, hd) -> (B, S, H, hd) in q's dtype, the scores
    times ``scale`` (None: 1/sqrt(hd), the reference's). On the
    card the kernel's backward recomputes the score tiles whatever
    ``remat_step`` says (it never saves them); on the CPU ``remat_step``
    checkpoints each step of the plain loop. The kernel takes no cq: a
    query row's result depends only on the kv-chunks, visited in order.
    It takes K/V at every query head, so grouped K/V are repeated first."""
    if q.is_cuda:
        g = q.shape[2] // k.shape[2]
        if g > 1:
            k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
        return ChunkedAttention.apply(q, k, v, causal, ck, scale)
    return chunked_attention_ref(q, k, v, causal=causal, cq=cq, ck=ck, remat_step=remat_step,
                                 scale=scale)


encode_align.launches = 0
block_max.launches = 0
encode_wire.launches = 0
decode_fused.launches = 0
decode_fused.modes = {"format": 0, "leaf": 0}
extract.launches = 0
align.launches = 0
decode.launches = 0
accum.launches = 0
accum.launches_by_mode = {"local": 0, "leaf": 0}
