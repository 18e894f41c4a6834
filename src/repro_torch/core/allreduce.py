"""Gradient-aggregation strategies over ``torch.distributed`` (torch port of
the flat strategies of ``repro.core.allreduce``).

native   : plain float SUM all-reduce — the no-switch baseline.
switchml : SwitchML (Sapio et al., NSDI'21): per-block max-exponent round
           trip (collective #1), int32 fixed-point quantize -> int SUM
           (collective #2) -> dequantize, with exact power-of-two half-factors.
fpisa    : the paper's technique: block-exponent planes, mantissas aligned
           with a worker-count pre-shift, one small int32 MAX all-reduce of
           the block exponents and one integer SUM all-reduce of the
           mantissas, delayed renormalization after the collective.
           Bit-reproducible for any reduction order (integer add is
           associative and commutative).
fpisa_seq : bit-faithful switch-arrival semantics: the leaf is all-gathered
           in rank order and summed with sequential FPISA-A over the worker
           axis, worker 0 first (``fpisa.fpisa_sum_sequential``). Used by
           accuracy experiments; not a production path (W x bytes on the
           wire). The reference runs its sum as a jnp scan; the port runs
           it as the Hopper kernel K6 (``ops.accum``) on the ``cuda``
           backend and as ``fpisa_sum_sequential`` on ``torch``, which give
           the same bits.
switch_emu : validation strategy: the all-gathered per-worker gradients go
           to the host as numpy and through the switch-dataplane emulator
           (``repro_torch.switchsim``: slot pool, worker bitmaps, streaming
           window, packetization) on a lossless fabric, as the reference's
           host callback sends them. Bit-identical to ``fpisa_seq`` (the
           zero-drop arrival order is worker-major per chunk). The host trip
           is the strategy's semantics, not a fallback; never a hot path.

The encode->align before the SUM and the decode after it run as the Hopper
kernels of ``kernels/fpisa_fused.py`` on the ``cuda`` backend, and as the
plain reference formulation on ``torch`` (see ``core/agg.py``); the two are
bit-identical. The residual shift to the cross-worker exponent and the wire
cast between them are plain torch.

16-bit wire: neither gloo nor NCCL has an int16 SUM, so a 16-bit wire plane
is carried on the collective as int32 values. They are the same values (the
wire shift guarantees every partial sum fits int16), so the result is
bit-identical to the reference's int16 psum, at twice the bytes.

Not ported yet: hierarchical, stacked, chunked and bucketed aggregation and
the multi-tenant ``switch_shared`` dataplane (ROADMAP.md).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.core import fpisa
from repro_torch.core import numerics as nx
from repro_torch.core.agg import AggConfig, register_strategy, resolve_backend, world_size
from repro_torch.kernels import ops
from repro_torch.switchsim import DataplaneConfig, NumpyDataplane, run_aggregation

# ---------------------------------------------------------------------------
# collectives (a world of one, with no process group, reduces to identity)
# ---------------------------------------------------------------------------


def _all_reduce_(t: torch.Tensor, op, group) -> torch.Tensor:
    """In-place all-reduce of a tensor this module owns."""
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(t, op=op, group=group)
    return t


def _all_gather_rows(flat: torch.Tensor, group) -> torch.Tensor:
    """(N,) -> (W, N): every rank's tensor, in rank order (worker 0 first)."""
    if not (dist.is_available() and dist.is_initialized()):
        return flat[None]
    rows = flat.new_empty((dist.get_world_size(group), flat.shape[0]))
    dist.all_gather(list(rows.unbind(0)), flat, group=group)
    return rows


def _pmax(t: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce_(t.clone(), dist.ReduceOp.MAX, group)


def _psum_wire(man: torch.Tensor, group) -> torch.Tensor:
    """Integer SUM of a wire plane that this module owns. int16 travels as
    int32 (no int16 SUM on gloo or NCCL; same values, see module doc)."""
    if man.dtype == torch.int16:
        man = man.to(torch.int32)
    return _all_reduce_(man, dist.ReduceOp.SUM, group)


# ---------------------------------------------------------------------------
# backend layer: encode->align (pre-collective) / decode (post-collective)
# ---------------------------------------------------------------------------


def _encode_align(flat: torch.Tensor, group, shift: int, cfg: AggConfig, backend: str):
    """flat (N,) packed FP -> (man (N,) int32 aligned to the cross-worker
    block exponent and pre-shifted by ``shift``, bmax (N/block,) int32).

    Runs the block-exponent MAX all-reduce between the local extract and the
    final alignment. The cuda backend extracts and aligns to the local block
    max in one kernel pass, then applies the residual per-element shift."""
    if backend == "cuda":
        man_local, local_bmax = ops.encode_align(flat.reshape(-1, cfg.block), cfg.fmt_name)
        bmax = _pmax(local_bmax, group)
        man = nx.arshift(man_local, (bmax - local_bmax)[:, None] + shift)
        return man.reshape(-1), bmax
    planes = fpisa.encode(flat, cfg.fmt)
    bmax = _pmax(fpisa.block_max_exponent(planes.exp, cfg.block), group)
    be = bmax.repeat_interleave(cfg.block)
    return nx.arshift(planes.man, (be - planes.exp) + shift), bmax


def _decode(man_sum: torch.Tensor, bmax: torch.Tensor, shift: int, cfg: AggConfig,
            backend: str) -> torch.Tensor:
    """(N,) aggregated mantissas (any wire dtype) + (N/block,) block exps ->
    (N,) packed FP via delayed renormalization."""
    if backend == "cuda":
        out = ops.decode_fused(man_sum.reshape(-1, cfg.block), bmax, shift, cfg.fmt_name)
        return out.reshape(-1)
    return fpisa.block_decode(man_sum.to(torch.int32), bmax, cfg.block, shift, cfg.fmt)


def _flatten_pad(x: torch.Tensor, block: int):
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, pad


def _unflatten(flat: torch.Tensor, pad: int, shape, dtype) -> torch.Tensor:
    if pad:
        flat = flat[: flat.shape[0] - pad]
    return flat.reshape(shape).to(dtype)


# ---------------------------------------------------------------------------
# native
# ---------------------------------------------------------------------------


def native_allreduce(x: torch.Tensor, group, cfg: AggConfig) -> torch.Tensor:
    """plain float SUM all-reduce — the no-switch baseline"""
    if world_size(group) == 1:
        return x
    return _all_reduce_(x.clone(), dist.ReduceOp.SUM, group)


# ---------------------------------------------------------------------------
# SwitchML baseline
# ---------------------------------------------------------------------------


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact float32 2^e for integer e in [-126, 127], by bit assembly."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def switchml_allreduce(x: torch.Tensor, group, cfg: AggConfig) -> torch.Tensor:
    """SwitchML int32 fixed-point with a scale-factor round trip.

    Block c uses scale 2^(man_bits - s) / 2^(e_max(c) - bias), with e_max
    agreed by a separate MAX all-reduce (the round trip FPISA removes). The
    scale exponent reaches about +-150, past float32's range, so it is
    applied as two exact bit-assembled power-of-two half-factors. All-zero /
    all-denormal blocks (e_max == 0) quantize to exactly 0."""
    w = world_size(group)
    fmt = cfg.fmt
    orig_shape, orig_dtype = x.shape, x.dtype
    flat, pad = _flatten_pad(x.to(torch.float32), cfg.block)

    planes = fpisa.encode(flat, fmt)
    # round 1: max-exponent agreement (extra round trip in SwitchML)
    bmax = _pmax(fpisa.block_max_exponent(planes.exp, cfg.block), group)

    s = nx.required_preshift(w, fmt)
    be = bmax.repeat_interleave(cfg.block)
    k = (fmt.man_bits - s) - (be - fmt.bias)
    k1 = torch.div(k, 2, rounding_mode="floor")
    k2 = k - k1
    live = be > 0
    q = torch.where(live, torch.round((flat * _pow2(k1)) * _pow2(k2)), 0.0).to(torch.int32)
    # round 2: integer aggregation (the in-switch op)
    qsum = _all_reduce_(q, dist.ReduceOp.SUM, group)
    out = torch.where(live, (qsum.to(torch.float32) * _pow2(-k1)) * _pow2(-k2), 0.0)
    return _unflatten(out, pad, orig_shape, orig_dtype)


# ---------------------------------------------------------------------------
# FPISA
# ---------------------------------------------------------------------------


def _check_wire_capacity(w: int, wire_bits: int) -> None:
    """No shift can make a narrow wire safe beyond w = 2^(wire_bits - 1)
    summands: the arithmetic right shift floors every negative mantissa at -1
    (round toward -inf), so a same-signed reduction can always reach -w."""
    if wire_bits < 32 and w > 1 << (wire_bits - 1):
        raise ValueError(
            f"wire_bits={wire_bits} cannot carry a {w}-way sum: negative "
            f"mantissas floor at -1 under the arithmetic pre-shift, so the "
            f"reduction can reach -{w} < -2^{wire_bits - 1}")


def _wire_shift(fmt: fpisa.FpFormat, w: int, wire_bits: int) -> int:
    """Extra right-shift so each aligned mantissa fits in `wire_bits` signed
    ints AND the integer sum over w workers cannot overflow the wire dtype."""
    s = nx.required_preshift(w, fmt)
    if wire_bits >= 32:
        return s
    _check_wire_capacity(w, wire_bits)
    # element magnitude < 2^(man_bits + 1 - t); need w * that <= 2^(wire_bits - 1)
    t = fmt.man_bits + 1 + math.ceil(math.log2(max(w, 1))) - (wire_bits - 1)
    return max(s, t)


def _wire_cast(man: torch.Tensor, wire_bits: int) -> torch.Tensor:
    """Cast a mantissa plane to the wire element dtype (lossless: the wire
    shift guarantees every value, and every partial sum, fits)."""
    if wire_bits == 16:
        return man.to(torch.int16)
    if wire_bits == 8:
        return man.to(torch.int8)
    return man


def fpisa_allreduce(x: torch.Tensor, group, cfg: AggConfig) -> torch.Tensor:
    """the paper's block-exponent integer planes (production path)

    The input is handled in the format's packed dtype (staged through a cast
    when the leaf has another dtype); the result is cast back to the leaf's
    dtype."""
    w = world_size(group)
    backend = resolve_backend(cfg.backend, x.device)
    orig_shape, orig_dtype = x.shape, x.dtype
    flat, pad = _flatten_pad(x.to(fpisa.PACKED_DTYPE[cfg.fmt_name]), cfg.block)

    shift = _wire_shift(cfg.fmt, w, cfg.wire_bits)
    man, bmax = _encode_align(flat, group, shift, cfg, backend)
    man_sum = _psum_wire(_wire_cast(man, cfg.wire_bits), group)
    out = _decode(man_sum, bmax, shift, cfg, backend)
    return _unflatten(out, pad, orig_shape, orig_dtype)


# ---------------------------------------------------------------------------
# bit-faithful sequential variant (accuracy experiments) and its emulation
# ---------------------------------------------------------------------------


def fpisa_seq_allreduce(x: torch.Tensor, group, cfg: AggConfig) -> torch.Tensor:
    """bit-faithful sequential switch-arrival FPISA-A

    The (W, N) stack of all ranks' leaves, cast to the format's packed dtype,
    summed worker 0 first; the result is cast back to the leaf's dtype. On
    the cuda backend the stack goes through K6 as one (W, 1, N) row, since
    the sum is elementwise (float32 out, the format's value exactly), on
    torch through ``fpisa_sum_sequential`` (the format's dtype): the same
    values."""
    backend = resolve_backend(cfg.backend, x.device)
    packed = fpisa.PACKED_DTYPE[cfg.fmt_name]
    stacked = _all_gather_rows(x.to(torch.float32).reshape(-1), group).to(packed)
    if backend == "cuda":
        out = ops.accum(stacked[:, None], "fpisa_a", cfg.fmt_name)
    else:
        out = fpisa.fpisa_sum_sequential(stacked, cfg.fmt, variant="fpisa_a")
    return out.reshape(x.shape).to(x.dtype)


def _validate_switch_emu(cfg: AggConfig) -> None:
    if cfg.fmt_name != "fp32":
        raise ValueError(
            "switch_emu runs on the numpy dataplane, which is fp32-only; got "
            f"fmt_name={cfg.fmt_name!r}")


def switch_emu_allreduce(x: torch.Tensor, group, cfg: AggConfig) -> torch.Tensor:
    """validation via the switch-dataplane emulator

    All-gather the ranks' leaves, take them to the host as numpy (as the
    reference's host callback does) and run them through ``NumpyDataplane``
    on a lossless fabric: real slot pool, worker bitmaps, streaming window
    and packetization. Bit-identical to ``fpisa_seq``. fp32 only (checked
    when the Aggregator is built)."""
    stacked = _all_gather_rows(x.to(torch.float32).reshape(-1), group)
    dp = NumpyDataplane(DataplaneConfig(num_workers=stacked.shape[0], fmt_name="fp32",
                                        variant="fpisa_a"))
    out = run_aggregation(dp, stacked.cpu().numpy())  # float32
    return torch.from_numpy(out).to(x.device).reshape(x.shape).to(x.dtype)


register_strategy("native")(native_allreduce)
register_strategy("switchml")(switchml_allreduce)
register_strategy("fpisa")(fpisa_allreduce)
register_strategy("fpisa_seq")(fpisa_seq_allreduce)
register_strategy("switch_emu", validate=_validate_switch_emu)(switch_emu_allreduce)
