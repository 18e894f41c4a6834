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
           wire). The reference gathers float32 rows and runs its sum as a
           jnp scan; the port gathers the leaf in its own dtype where the
           cast to the format is exact and runs the sum as K6's leaf mode
           (``ops.accum_leaf``: the widening, the sum and the cast back in
           one pass) on the ``cuda`` backend, as ``fpisa_sum_sequential``
           on ``torch``; the two give the same bits.
switch_emu : validation strategy: the all-gathered per-worker gradients go
           to the host as numpy and through the switch-dataplane emulator
           (``repro_torch.switchsim``: slot pool, worker bitmaps, streaming
           window, packetization) on a lossless fabric, as the reference's
           host callback sends them. Bit-identical to ``fpisa_seq`` (the
           zero-drop arrival order is worker-major per chunk). The host trip
           is the strategy's semantics, not a fallback; never a hot path.
           With ``cfg.switch_shared`` set, the traffic rides the named
           process-shared multi-tenant dataplane as tenant ``switch_job`` of
           ``switch_jobs`` (``switchsim.tenancy``); the bits are unchanged.

The encode->align before the SUM and the decode after it run as the Hopper
kernels of ``kernels/fpisa_fused.py`` on the ``cuda`` backend, and as the
plain reference formulation on ``torch`` (see ``core/agg.py``); the two are
bit-identical. On ``cuda`` a leaf goes through K1's exponent mode (block
max over the rank's workers), the MAX all-reduce, K1's wire mode (the
alignment to the agreed exponent in one shift, the wire cast and the fold
over the rank's logical workers), the SUM, and K2 in the leaf's dtype: no
shift, cast or fold runs in torch between the kernels and the collectives.
The kernels read a leaf whose cast to the format is exact (the format's
dtype, or fp16/bf16 into fp32) as it is; any other leaf is cast first
(``fpisa.to_packed``, with F9's NaN rule). What stays eager: that narrowing
cast (on the ``fpisa_seq`` paths too), the bucketer's pack and unpack casts
(``fpisa_seq``'s float32 pack included), and the hierarchical path's
pod-hop shift and cast and its decode to the format's dtype.

16-bit wire: neither gloo nor NCCL has an int16 SUM, so a 16-bit wire plane
is carried on the collective as int32 values. They are the same values (the
wire shift guarantees every partial sum fits int16), so the result is
bit-identical to the reference's int16 psum, at twice the bytes.

Hierarchical (``fpisa`` over a ``(pod_group, data_group)`` pair): integer
reduce-scatter over the data group, an optional narrower wire with its extra
shift for the SUM over the pod group, the delayed renormalization of this
rank's owned shard, and an all-gather over the data group. Every other
strategy given a pair reduces over both groups in turn (data, then pod).
The split-phase hooks at the end (``_fpisa_flat_phases``,
``_fpisa_hier_phases``) are what ``core/bucketer.py`` pipelines; their
collective is launched with ``async_op=True`` and ``finish`` waits on its
work handle.

Stacked (logical-worker) variants (``stacked_*``) reduce a leading worker
axis of k as well as the group (section doc below).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.core import fpisa
from repro_torch.core import numerics as nx
from repro_torch.core.agg import (
    AggConfig, _initialized, group_rank, register_strategy, resolve_backend, world_size,
)
from repro_torch.kernels import ops
from repro_torch.kernels.fpisa_fused import widens
from repro_torch.switchsim import (
    DataplaneConfig, NumpyDataplane, run_aggregation, shared_emulated_allreduce,
)

# ---------------------------------------------------------------------------
# collectives (a world of one, with no process group, reduces to identity).
# ``group`` is a process group, None, or a (pod_group, data_group) pair,
# which is reduced over its data group, then its pod group.
# ---------------------------------------------------------------------------


def _all_reduce_(t: torch.Tensor, op, group) -> torch.Tensor:
    """In-place all-reduce of a tensor this module owns."""
    if _initialized():
        for g in (reversed(group) if isinstance(group, tuple) else (group,)):
            dist.all_reduce(t, op=op, group=g)
    return t


def _all_gather_rows(flat: torch.Tensor, group) -> torch.Tensor:
    """(N,) -> (W, N): every rank's tensor, in rank order (worker 0 first;
    over a pair, pod-major: pod * w_data + data). A group of one rank
    gathers nothing: the rows are a view of ``flat``."""
    if world_size(group) == 1:
        return flat[None]
    if isinstance(group, tuple):
        pod_group, data_group = group
        rows = _all_gather_rows(_all_gather_rows(flat, data_group).reshape(-1), pod_group)
        return rows.reshape(-1, flat.shape[0])
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


def _psum_wire_start(man: torch.Tensor, group):
    """``_psum_wire`` launched with ``async_op=True``: returns (work handle,
    the tensor the sum lands in); the caller waits on the handle before
    reading it. The handle is None when nothing is left in flight (no
    process group, or a group pair, which is summed in turn)."""
    if not _initialized() or isinstance(group, tuple):
        return None, _psum_wire(man, group)
    if man.dtype == torch.int16:
        man = man.to(torch.int32)
    return dist.all_reduce(man, op=dist.ReduceOp.SUM, group=group, async_op=True), man


def _reduce_scatter(man: torch.Tensor, group) -> torch.Tensor:
    """(N,) int32 -> this rank's contiguous (N / w,) shard of the SUM over
    ``group`` (shard i belongs to group rank i)."""
    w = world_size(group)
    if w == 1:
        return man
    shard = man.new_empty(man.shape[0] // w)
    dist.reduce_scatter_tensor(shard, man, op=dist.ReduceOp.SUM, group=group)
    return shard


# ---------------------------------------------------------------------------
# backend layer: encode->align (pre-collective) / decode (post-collective)
# ---------------------------------------------------------------------------


def _kernel_input(x: torch.Tensor, cfg: AggConfig) -> torch.Tensor:
    """A leaf as K1's exponent and wire modes read it: as it is where its
    cast to the format is exact, else cast by ``fpisa.to_packed``. The
    kernels move 16-byte words, so a view that starts off a 16-byte
    boundary (a chunk cut at an odd offset) is copied first."""
    if not widens(x.dtype, cfg.fmt_name):
        x = fpisa.to_packed(x, cfg.fmt_name)
    if x.data_ptr() % 16:
        x = x.clone()
    return x


def _encode_align(flat: torch.Tensor, group, shift: int, wire_bits: int, cfg: AggConfig,
                  backend: str):
    """flat (N,) leaf -> (the wire plane (N,): mantissas aligned to the
    cross-worker block exponent, pre-shifted by ``shift`` and cast to the
    ``wire_bits`` wire, bmax (N/block,) int32).

    Runs the block-exponent MAX all-reduce between the exponents and the
    alignment. The cuda backend runs K1's exponent mode, the MAX, then K1's
    wire mode (one pass: encode, align, wire cast; a 16-bit wire comes out
    as int32); the torch backend is the reference formulation."""
    if backend == "cuda":
        x = _kernel_input(flat, cfg).reshape(1, -1, cfg.block)
        bmax = _all_reduce_(ops.block_max(x, cfg.fmt_name), dist.ReduceOp.MAX, group)
        return ops.encode_wire(x, bmax, shift, wire_bits, cfg.fmt_name).reshape(-1), bmax
    planes = fpisa.encode(flat, cfg.fmt)
    bmax = _pmax(fpisa.block_max_exponent(planes.exp, cfg.block), group)
    be = bmax.repeat_interleave(cfg.block)
    return _wire_cast(nx.arshift(planes.man, (be - planes.exp) + shift), wire_bits), bmax


def _decode(man_sum: torch.Tensor, bmax: torch.Tensor, shift: int, cfg: AggConfig,
            backend: str, dtype: torch.dtype | None = None) -> torch.Tensor:
    """(N,) aggregated mantissas (any wire dtype) + (N/block,) block exps ->
    (N,) FP via delayed renormalization, in the format's dtype or cast to
    ``dtype`` (K2 casts in registers)."""
    if backend == "cuda":  # K2 writes fp32, fp16 or bf16; _unflatten casts to any other
        out = ops.decode_fused(man_sum.reshape(-1, cfg.block), bmax, shift, cfg.fmt_name,
                               dtype if dtype in fpisa.FMT_OF_DTYPE else None)
        return out.reshape(-1)
    out = fpisa.block_decode(man_sum.to(torch.int32), bmax, cfg.block, shift, cfg.fmt)
    return out if dtype is None else out.to(dtype)


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
    q = nx.f32_to_int32(torch.where(live, torch.round((flat * _pow2(k1)) * _pow2(k2)), 0.0))
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

    The input is encoded in the format (``fpisa.encode`` casts it on the
    torch backend; K1 widens it, or it is cast first, on cuda); the result
    is decoded in the leaf's dtype."""
    w = world_size(group)
    backend = resolve_backend(cfg.backend, x.device)
    flat, pad = _flatten_pad(x, cfg.block)

    shift = _wire_shift(cfg.fmt, w, cfg.wire_bits)
    man, bmax = _encode_align(flat, group, shift, cfg.wire_bits, cfg, backend)
    man_sum = _psum_wire(man, group)
    out = _decode(man_sum, bmax, shift, cfg, backend, x.dtype)
    return _unflatten(out, pad, x.shape, x.dtype)


def _hier_collect(man: torch.Tensor, data_group, pod_group, cfg: AggConfig,
                  shift: int, *, async_op: bool = False):
    """Two-level integer collective: reduce-scatter over the data group, then
    SUM over the pod group. Returns (man_shard, pod_shift, work): ``work``
    is the pod SUM's handle under ``async_op`` (None otherwise, or when
    nothing is in flight), which the caller waits on before reading
    ``man_shard``.

    The data-group partial sums carry up to man_bits + 1 + log2(w_data)
    magnitude bits; a narrower pod wire takes one extra truncating shift,
    applied once, after the full-precision data-group reduction."""
    fmt = cfg.fmt
    w_data, w_pod = world_size(data_group), world_size(pod_group)
    man_shard = _reduce_scatter(man, data_group)
    pod_bits = cfg.pod_wire_bits or cfg.wire_bits
    pod_shift = 0
    if pod_bits < 32:
        # same floor-at--1 rail as _wire_shift, for the pod summand count
        _check_wire_capacity(w_pod, pod_bits)
        partial_mag_bits = (fmt.man_bits + 1 - shift) + math.ceil(math.log2(max(w_data, 1)))
        pod_shift = max(0, partial_mag_bits + math.ceil(math.log2(max(w_pod, 1)))
                        - (pod_bits - 1))
        man_shard = _wire_cast(nx.arshift(man_shard, pod_shift), pod_bits)
    if async_op:
        work, man_shard = _psum_wire_start(man_shard, pod_group)
        return man_shard, pod_shift, work
    return _psum_wire(man_shard, pod_group), pod_shift, None


def _hier_finish(man_shard: torch.Tensor, bmax: torch.Tensor, shift: int,
                 pod_shift: int, data_group, cfg: AggConfig, backend: str) -> torch.Tensor:
    """Delayed renormalization of this rank's owned shard only (with the
    block exponents of its data-group index), then an all-gather of the
    packed FP over the data group."""
    w_data = world_size(data_group)
    per = bmax.shape[0] // w_data
    idx = group_rank(data_group)
    bmax_shard = bmax[idx * per:(idx + 1) * per]
    out_shard = _decode(man_shard, bmax_shard, shift + pod_shift, cfg, backend)
    return _all_gather_rows(out_shard, data_group).reshape(-1)


def fpisa_allreduce_hierarchical(x: torch.Tensor, data_group, pod_group,
                                 cfg: AggConfig) -> torch.Tensor:
    """Two-level FPISA aggregation over a (pod, data) layout.

    Data group (cheap links): reduce-scatter of the int32 mantissas. Pod
    group (the expensive hop): SUM, optionally on a narrower wire. Data
    group: all-gather of the renormalized result. Exponent agreement is over
    both groups, so the mantissa scales are compatible across both levels;
    the sum stays in the integer domain and renormalization happens once."""
    w = world_size(data_group) * world_size(pod_group)
    backend = resolve_backend(cfg.backend, x.device)
    orig_shape, orig_dtype = x.shape, x.dtype
    # pad to block * w_data so the reduce-scatter tiles evenly
    flat, pad = _flatten_pad(x, cfg.block * world_size(data_group))

    shift = _wire_shift(cfg.fmt, w, cfg.wire_bits)
    # full precision into the data-group reduce-scatter: the 32-bit wire
    man, bmax = _encode_align(flat, (pod_group, data_group), shift, 32, cfg, backend)
    man_shard, pod_shift, _ = _hier_collect(man, data_group, pod_group, cfg, shift)
    out = _hier_finish(man_shard, bmax, shift, pod_shift, data_group, cfg, backend)
    return _unflatten(out, pad, orig_shape, orig_dtype)


# ---------------------------------------------------------------------------
# bit-faithful sequential variant (accuracy experiments) and its emulation
# ---------------------------------------------------------------------------


def _seq_input(x: torch.Tensor, cfg: AggConfig) -> torch.Tensor:
    """A leaf as the switch-arrival sum reads it: as it is where its cast to
    the format is exact (``widens``: K6's leaf mode widens it in registers),
    else staged in the format's dtype as the reference stages it, the
    float32 upcast and then the narrowing cast (``fpisa.to_packed``, F11's
    and F9's NaN rules)."""
    if widens(x.dtype, cfg.fmt_name):
        return x
    return fpisa.to_packed(fpisa.to_packed(x, "fp32"), cfg.fmt_name)


def _seq_sum(rows: torch.Tensor, cfg: AggConfig, backend: str) -> torch.Tensor:
    """(W, N) rows in worker order, of a dtype the format widens -> (N,)
    switch-arrival FPISA-A sum, worker 0 first: K6's leaf mode on the cuda
    backend (the rows' dtype out, rounded as the cast to it rounds),
    ``fpisa_sum_sequential`` on torch (the format's dtype): the same values
    once cast to the leaf's dtype."""
    if backend == "cuda":
        return ops.accum_leaf(rows, "fpisa_a", cfg.fmt_name)
    return fpisa.fpisa_sum_sequential(rows, cfg.fmt, variant="fpisa_a")


def fpisa_seq_allreduce(x: torch.Tensor, group, cfg: AggConfig) -> torch.Tensor:
    """bit-faithful sequential switch-arrival FPISA-A

    The (W, N) stack of all ranks' leaves, gathered in the leaf's dtype
    (``_seq_input``), summed worker 0 first (``_seq_sum``); the result is
    cast back to the leaf's dtype. The reference gathers float32 rows; the
    widening to them is exact, so the sum is the same."""
    backend = resolve_backend(cfg.backend, x.device)
    rows = _all_gather_rows(_seq_input(x, cfg).reshape(-1), group)
    return _seq_sum(rows, cfg, backend).reshape(x.shape).to(x.dtype)


def _validate_switch_emu(cfg: AggConfig) -> None:
    if cfg.fmt_name != "fp32":
        raise ValueError(
            "switch_emu runs on the numpy dataplane, which is fp32-only; got "
            f"fmt_name={cfg.fmt_name!r}")


def _switch_emulate(rows: torch.Tensor, cfg: AggConfig) -> torch.Tensor:
    """(W, N) float32 rows, one per switch port in worker order -> (N,)
    float32 through ``NumpyDataplane`` on the host, on a lossless fabric:
    a private one, or as tenant ``cfg.switch_job`` of the named shared one
    (``cfg.switch_shared``). The result goes back to the rows' device."""
    vals = rows.cpu().numpy()
    if cfg.switch_shared is not None:
        out = shared_emulated_allreduce(cfg.switch_shared, vals,
                                        num_jobs=cfg.switch_jobs, job=cfg.switch_job)
    else:
        dp = NumpyDataplane(DataplaneConfig(num_workers=rows.shape[0], fmt_name="fp32",
                                            variant="fpisa_a"))
        out = run_aggregation(dp, vals)  # float32
    return torch.from_numpy(out).to(rows.device)


def switch_emu_allreduce(x: torch.Tensor, group, cfg: AggConfig) -> torch.Tensor:
    """validation via the switch-dataplane emulator

    All-gather the ranks' leaves, take them to the host as numpy (as the
    reference's host callback does) and run them through ``NumpyDataplane``
    on a lossless fabric: real slot pool, worker bitmaps, streaming window
    and packetization. Bit-identical to ``fpisa_seq``. fp32 only (checked
    when the Aggregator is built).

    With ``cfg.switch_shared`` set, the traffic instead rides the named
    process-shared multi-tenant dataplane as tenant ``cfg.switch_job`` of
    ``cfg.switch_jobs`` (``switchsim.tenancy``), as in the reference:
    several aggregators (and query streams) then contend for one emulated
    switch. The bits are unchanged: a lossless fabric delivers every result
    however admission interleaves the claims."""
    rows = _all_gather_rows(x.to(torch.float32).reshape(-1), group)
    return _switch_emulate(rows, cfg).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# stacked (logical-worker) aggregation: elastic fault tolerance
# ---------------------------------------------------------------------------
#
# ``stacked_*`` variants reduce over a LEADING logical-worker axis as well as
# the group: x has shape (k, ...) where this rank hosts k of the job's
# W = k * world logical workers (rank d hosts workers [d*k, (d+1)*k)). The
# reduction over logical workers runs entirely in the integer domain
# (mantissa planes for fpisa, fixed point for switchml, arrival-ordered rows
# for fpisa_seq / switch_emu), and the wire shift is derived from W, not the
# group size, so the aggregated bits are IDENTICAL for any placement of the
# W workers over any group that divides W. That is what elastic recovery
# rests on: after a host death the survivors regroup with k' > k workers per
# rank and training continues bit for bit (runtime/controller.py). A group
# pair is reduced jointly (flat): the flat integer sum equals the
# hierarchical one at equal W. ``native`` sums floats, whose result depends
# on the grouping; it carries no bit-identity guarantee.


def _stacked_rows(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).to(dtype)


def _stacked_pad(rows: torch.Tensor, quantum: int):
    pad = (-rows.shape[1]) % quantum
    if pad:
        rows = torch.cat([rows, rows.new_zeros(rows.shape[0], pad)], dim=1)
    return rows, pad


def _encode_align_stacked(rows: torch.Tensor, group, shift: int, wire_bits: int,
                          cfg: AggConfig, backend: str):
    """rows (k, Nb) leaf -> (the (Nb,) wire plane: the k workers' mantissas
    aligned to the block exponent maxed over ALL W logical workers, each
    cast to the wire and folded in int32, bmax (Nb/block,) int32).

    The block max folds the local worker axis before the MAX all-reduce;
    max is associative, so the agreed exponent (and with it every aligned
    mantissa) does not depend on the placement of the workers. The cuda
    backend runs K1's exponent mode over the (k, Nb/block, block) stack,
    the MAX, then K1's wire mode, which takes in the fold."""
    k = rows.shape[0]
    if backend == "cuda":
        x = _kernel_input(rows, cfg).reshape(k, -1, cfg.block)
        bmax = _all_reduce_(ops.block_max(x, cfg.fmt_name), dist.ReduceOp.MAX, group)
        return ops.encode_wire(x, bmax, shift, wire_bits, cfg.fmt_name).reshape(-1), bmax
    planes = fpisa.encode(rows, cfg.fmt)
    local_bmax = fpisa.block_max_exponent(planes.exp, cfg.block)  # (k, nblocks)
    bmax = _pmax(local_bmax.amax(0), group)
    be = bmax.repeat_interleave(cfg.block)[None, :]
    return _fold_workers(nx.arshift(planes.man, (be - planes.exp) + shift), wire_bits), bmax


def _fold_workers(man: torch.Tensor, wire_bits: int) -> torch.Tensor:
    """(k, N) per-worker wire payloads -> (N,) their exact int32 sum, cast
    to the wire again (every partial fits: the shift is derived from W)."""
    man = _wire_cast(man, wire_bits)
    return _wire_cast(man.to(torch.int32).sum(0, dtype=torch.int32), wire_bits)


def stacked_native_allreduce(x: torch.Tensor, group, cfg: AggConfig) -> torch.Tensor:
    """float SUM over the worker axis, then over the group"""
    return _all_reduce_(x.sum(0), dist.ReduceOp.SUM, group)


def stacked_fpisa_allreduce(x: torch.Tensor, group, cfg: AggConfig) -> torch.Tensor:
    """FPISA aggregation over (leading logical-worker axis) + group.

    Each logical worker's mantissas are wire-cast on their own (its packet
    payload), summed over the local workers in int32 (exact: every partial
    fits the wire by the W-derived shift), then summed over the group.
    Integer addition is associative and commutative, so the result is
    bit-identical for every placement of the W workers."""
    k = x.shape[0]
    w = k * world_size(group)
    backend = resolve_backend(cfg.backend, x.device)
    rows, pad = _stacked_pad(x.reshape(k, -1), cfg.block)

    shift = _wire_shift(cfg.fmt, w, cfg.wire_bits)
    man, bmax = _encode_align_stacked(rows, group, shift, cfg.wire_bits, cfg, backend)
    man_sum = _psum_wire(man, group)
    out = _decode(man_sum, bmax, shift, cfg, backend, x.dtype)
    return _unflatten(out, pad, x.shape[1:], x.dtype)


def stacked_switchml_allreduce(x: torch.Tensor, group, cfg: AggConfig) -> torch.Tensor:
    """SwitchML fixed point with W logical workers (``switchml_allreduce``
    has the scale mechanics): per-worker quantization, exact int32 fold
    over the local workers, integer SUM over the group."""
    k = x.shape[0]
    w = k * world_size(group)
    fmt = cfg.fmt
    orig_shape, orig_dtype = x.shape[1:], x.dtype
    rows, pad = _stacked_pad(_stacked_rows(x, torch.float32), cfg.block)

    planes = fpisa.encode(rows, fmt)
    bmax = _pmax(fpisa.block_max_exponent(planes.exp, cfg.block).amax(0), group)

    s = nx.required_preshift(w, fmt)
    be = bmax.repeat_interleave(cfg.block)
    kexp = (fmt.man_bits - s) - (be - fmt.bias)
    k1 = torch.div(kexp, 2, rounding_mode="floor")
    k2 = kexp - k1
    live = be > 0
    q = nx.f32_to_int32(torch.where(
        live[None, :], torch.round((rows * _pow2(k1)[None, :]) * _pow2(k2)[None, :]), 0.0))
    qsum = _all_reduce_(q.sum(0, dtype=torch.int32), dist.ReduceOp.SUM, group)
    out = torch.where(live, (qsum.to(torch.float32) * _pow2(-k1)) * _pow2(-k2), 0.0)
    return _unflatten(out, pad, orig_shape, orig_dtype)


def _gather_logical(rows: torch.Tensor, group) -> torch.Tensor:
    """(k, N) per-rank rows -> (W, N) rows in logical-worker order, in the
    rows' dtype. Rank d hosts workers [d*k, (d+1)*k), so the rank-order
    all-gather IS the logical order, for every group size."""
    return _all_gather_rows(rows.reshape(-1), group).reshape(-1, rows.shape[1])


def stacked_fpisa_seq_allreduce(x: torch.Tensor, group, cfg: AggConfig) -> torch.Tensor:
    """switch-arrival FPISA-A over the W logical workers in logical order,
    gathered in the leaf's dtype as in ``fpisa_seq_allreduce``"""
    backend = resolve_backend(cfg.backend, x.device)
    rows = _gather_logical(_seq_input(x, cfg).reshape(x.shape[0], -1), group)
    return _seq_sum(rows, cfg, backend).reshape(x.shape[1:]).to(x.dtype)


def stacked_switch_emu_allreduce(x: torch.Tensor, group, cfg: AggConfig) -> torch.Tensor:
    """validation with W logical switch ports: the gathered per-worker
    gradients stream through the numpy dataplane as in
    ``switch_emu_allreduce``; arrival order is logical-worker-major, the same
    for every placement, so kill-and-resume stays bit-exact under the full
    protocol emulation."""
    _validate_switch_emu(cfg)
    if cfg.switch_shared is not None:
        raise ValueError(
            "switch_shared tenancy is wired for the flat switch_emu path; "
            "the stacked (elastic logical-worker) variant does not support "
            "a shared dataplane")
    out = _switch_emulate(_gather_logical(_stacked_rows(x, torch.float32), group), cfg)
    return out.reshape(x.shape[1:]).to(x.dtype)


# ---------------------------------------------------------------------------
# split-phase pipeline factories (bucketer hooks)
# ---------------------------------------------------------------------------


def _sum_phases(group, shift: int, cfg: AggConfig, backend: str):
    """(collect, finish) of the flat and stacked fpisa paths: ``collect``
    launches the integer SUM with ``async_op=True``; ``finish`` waits on its
    handle, then decodes."""

    def collect(state):
        man, bmax = state
        work, man_sum = _psum_wire_start(man, group)
        return work, man_sum, bmax

    def finish(state):
        work, man_sum, bmax = state
        if work is not None:
            work.wait()
        return _decode(man_sum, bmax, shift, cfg, backend)

    return collect, finish


def _fpisa_flat_phases(group, cfg: AggConfig, backend: str):
    """(encode, collect, finish) for the flat fpisa path, mirroring
    ``fpisa_allreduce`` (bucket buffers are block multiples, so its pad is a
    no-op here)."""
    shift = _wire_shift(cfg.fmt, world_size(group), cfg.wire_bits)

    def encode(flat):
        return _encode_align(flat, group, shift, cfg.wire_bits, cfg, backend)

    return (encode, *_sum_phases(group, shift, cfg, backend))


def _fpisa_stacked_phases(group, cfg: AggConfig, backend: str, k: int):
    """(encode, collect, finish) for the stacked fpisa path, mirroring
    ``stacked_fpisa_allreduce``: per-worker encode and the exact local int
    fold before the wire, the W-derived shift, one delayed renormalization
    after the SUM."""
    shift = _wire_shift(cfg.fmt, k * world_size(group), cfg.wire_bits)

    def encode(buf):  # (k, elems) packed FP
        return _encode_align_stacked(buf, group, shift, cfg.wire_bits, cfg, backend)

    return (encode, *_sum_phases(group, shift, cfg, backend))


def _fpisa_hier_phases(data_group, pod_group, cfg: AggConfig, backend: str,
                       stripe: int):
    """(encode, collect, finish) for the hierarchical fpisa path.

    ``stripe`` rotates the reduce-scatter shard assignment of this bucket by
    whole shards (a block-multiple roll): bucket i's pod hop and delayed
    renormalization for a given gradient range land on data rank
    (rank + i) % w_data, striping consecutive buckets' pod traffic across
    the data ranks. Rolling by whole shards keeps every block's contents
    intact, so the result is bit-identical to the unstriped path."""
    w_data = world_size(data_group)
    shift = _wire_shift(cfg.fmt, w_data * world_size(pod_group), cfg.wire_bits)
    quantum = cfg.block * w_data

    def encode(flat):
        pad = (-flat.shape[0]) % quantum
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        roll = (stripe % w_data) * (flat.shape[0] // w_data)
        if roll:
            flat = torch.roll(flat, -roll)
        man, bmax = _encode_align(flat, (pod_group, data_group), shift, 32, cfg, backend)
        return man, bmax, pad, roll

    def collect(state):
        man, bmax, pad, roll = state
        man_shard, pod_shift, work = _hier_collect(
            man, data_group, pod_group, cfg, shift, async_op=True)
        return work, man_shard, bmax, pod_shift, pad, roll

    def finish(state):
        work, man_shard, bmax, pod_shift, pad, roll = state
        if work is not None:
            work.wait()
        out = _hier_finish(man_shard, bmax, shift, pod_shift, data_group, cfg, backend)
        if roll:
            out = torch.roll(out, roll)
        if pad:
            out = out[:out.shape[0] - pad]
        return out

    return encode, collect, finish


# ---------------------------------------------------------------------------
# registry (repro_torch.core.agg): capability flags are validated once at
# Aggregator construction; the bucketer pulls the split-phase hooks and
# staging dtypes from the same specs.
# ---------------------------------------------------------------------------


def _stage_native(cfg: AggConfig, group: str) -> torch.dtype:
    return getattr(torch, group)  # native sums in the leaf dtype


def _stage_packed(cfg: AggConfig, group: str) -> torch.dtype:
    return fpisa.PACKED_DTYPE[cfg.fmt_name]


register_strategy(
    "native", stacked=stacked_native_allreduce, chunk_noop=True, stage_dtype=_stage_native,
    description="plain float SUM all-reduce — the no-switch baseline",
)(native_allreduce)

register_strategy(
    "switchml", stacked=stacked_switchml_allreduce,
    description="SwitchML int32 fixed-point with a scale-factor round trip",
)(switchml_allreduce)

register_strategy(
    "fpisa", stacked=stacked_fpisa_allreduce, hierarchical=fpisa_allreduce_hierarchical,
    stage_dtype=_stage_packed,
    flat_phases=_fpisa_flat_phases, hier_phases=_fpisa_hier_phases,
    stacked_phases=_fpisa_stacked_phases,
    description="the paper's block-exponent integer planes (production path)",
)(fpisa_allreduce)

register_strategy(
    "fpisa_seq", stacked=stacked_fpisa_seq_allreduce,
    description="bit-faithful sequential switch-arrival FPISA-A",
)(fpisa_seq_allreduce)

register_strategy(
    "switch_emu", stacked=stacked_switch_emu_allreduce, validate=_validate_switch_emu,
    description="validation via the switch-dataplane emulator",
)(switch_emu_allreduce)
