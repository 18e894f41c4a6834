"""Block-aligned gradient bucketing with overlapped streaming aggregation
(torch port of ``repro.core.bucketer``).

The switch in the paper aggregates a *stream* of fixed-size packets cut from
the whole gradient; SwitchML (Sapio et al., NSDI'21) shows that the
end-to-end win comes from this bucketing and streaming, not from many small
per-leaf collectives, each paying a full encode/decode. This module is the
host-side analogue for the collectives of ``core/allreduce.py``:

* ``make_plan``   — a static :class:`BucketPlan`: the gradient tree's leaves
                    are grouped by dtype, scheduled in reverse flatten order
                    (the leaves whose gradients backprop produces first go on
                    the wire first) and packed into fixed-size wire buckets.
                    Every leaf starts at an offset padded up to the FPISA
                    block boundary and large leaves are split only at block
                    multiples, so **a block never spans two leaves** and every
                    block's contents equal the per-leaf path's blocks, which
                    is what makes every strategy bit-identical to per-leaf
                    aggregation.
* ``bucketed_allreduce_tree`` — packs, dispatches and reassembles. For a
                    strategy with split-phase hooks (``fpisa``) the dispatch
                    is **double-buffered**: encode(i) -> finish(i-1) ->
                    collective(i), the collective launched with
                    ``async_op=True`` and waited on in its finish. Over a
                    ``(pod_group, data_group)`` pair, consecutive buckets are
                    striped across the data ranks (whole-shard roll).

Overlap on one communicator: NCCL serializes the collectives of one
communicator in issue order, so the MAX all-reduce of bucket i's block
exponents (inside its encode) queues behind bucket i-1's SUM. What overlaps
is bucket i's local encode pass with bucket i-1's SUM in flight.

Bit-identity contract: for every strategy / backend / wire width, the result
equals the per-leaf ``allreduce_tree`` bit for bit. With ``chunk_elems`` set
too, the identity additionally requires ``chunk_elems % block == 0`` (the
Aggregator checks it).

Plans depend only on the leaf list: the reference flattens dicts by sorted
key, the port keeps the tree's own order (``named_parameters()``), so the
two plans agree for the same leaf list.

``bucketed_stacked_allreduce_tree`` does the same for per-logical-worker
gradient stacks (a leading worker axis of k on every leaf): the plan is the
unstacked plan of the per-worker leaves, so block boundaries and bucket cuts
are the same for every k, and the (k, bucket) buffers go through the same
double-buffered dispatch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch import trace as _trace
from repro_torch.core import agg as _agg
from repro_torch.core import fpisa
from repro_torch.core.agg import AggConfig


def _ceil_to(n: int, q: int) -> int:
    return -(-n // q) * q


def dtype_name(dtype: torch.dtype) -> str:
    """The reference's dtype group key (``"float32"``, ``"bfloat16"``)."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class Segment:
    """A block-aligned slice of one leaf placed inside one bucket."""

    leaf: int    # index into the tree's flattened leaf list
    start: int   # element offset within the flattened leaf
    size: int    # real leaf elements carried (0 = pure padding tail)
    span: int    # slots occupied in the bucket (block multiple, >= size)
    offset: int  # start offset within the bucket buffer


@dataclasses.dataclass(frozen=True)
class Bucket:
    index: int                     # dispatch order (reverse flatten order)
    group: str                     # dtype group key, e.g. "float32"
    elems: int                     # buffer length (sum of spans; block-aligned)
    segments: tuple[Segment, ...]


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    block: int
    bucket_elems: int              # target capacity per bucket, in elements
    buckets: tuple[Bucket, ...]    # in dispatch order
    passthrough: tuple[int, ...]   # leaf indices routed per-leaf (non-float /
                                   # zero-size): bucketing has nothing to gain


def make_plan(leaves: Sequence, *, block: int, bucket_bytes: int) -> BucketPlan:
    """Build the static packing plan from leaf shapes/dtypes.

    ``leaves`` are tensors (``device="meta"`` ones carry no data: the plan
    never touches values). Leaves are walked in REVERSE order and packed
    greedily into per-dtype-group open buckets; buckets are dispatched in the
    order they fill up."""
    if block <= 0:
        raise ValueError(f"block must be positive, got {block}")
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")

    buckets: list[Bucket] = []
    passthrough: list[int] = []
    open_buckets: dict[str, list[Segment]] = {}
    open_fill: dict[str, int] = {}
    capacity: dict[str, int] = {}

    def seal(group: str) -> None:
        segs = open_buckets.pop(group, [])
        if segs:
            buckets.append(Bucket(
                index=len(buckets), group=group,
                elems=sum(s.span for s in segs), segments=tuple(segs)))
        open_fill.pop(group, None)

    for i in reversed(range(len(leaves))):
        leaf = leaves[i]
        dtype = leaf.dtype
        size = int(math.prod(leaf.shape)) if len(leaf.shape) else 1
        if size == 0 or not dtype.is_floating_point:
            passthrough.append(i)
            continue
        group = dtype_name(dtype)
        if group not in capacity:
            capacity[group] = max(block, _ceil_to(bucket_bytes // dtype.itemsize, block))
        cap = capacity[group]
        padded = _ceil_to(size, block)
        start = 0
        while start < padded:
            fill = open_fill.get(group, 0)
            take = min(padded - start, cap - fill)
            open_buckets.setdefault(group, []).append(Segment(
                leaf=i, start=start, size=max(0, min(size, start + take) - start),
                span=take, offset=fill))
            open_fill[group] = fill + take
            start += take
            if open_fill[group] >= cap:
                seal(group)
    for group in list(open_buckets):
        seal(group)

    cap_any = max(capacity.values()) if capacity else block
    return BucketPlan(block=block, bucket_elems=cap_any,
                      buckets=tuple(buckets), passthrough=tuple(passthrough))


def plan_for_config(leaves: Sequence, cfg: AggConfig) -> BucketPlan:
    return make_plan(leaves, block=cfg.block, bucket_bytes=cfg.bucket_bytes)


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------


def _stage_dtype(cfg: AggConfig, group: str) -> torch.dtype:
    """Wire staging dtype of a bucket buffer: the same cast the per-leaf
    path applies to each leaf (a cast is elementwise, so cast-then-pack ==
    pack-then-cast). Declared per strategy on its registry spec
    (``StrategySpec.stage_dtype``); float32 by default."""
    spec = _agg.get_strategy(cfg.strategy)
    if spec.stage_dtype is not None:
        return spec.stage_dtype(cfg, group)
    return torch.float32  # switchml / fpisa_seq / switch_emu


def pack_bucket(bucket: Bucket, flat_leaves, stage_dtype: torch.dtype,
                device) -> torch.Tensor:
    """Assemble one bucket buffer from (already flattened) leaves: one
    preallocated ``stage_dtype`` buffer, each segment copied in by slice
    (``copy_`` casts), each padding tail zeroed. Leaves flattened to
    (k, n) stacks give a (k, elems) buffer, one row per logical worker."""
    lead = flat_leaves[bucket.segments[0].leaf].shape[:-1]
    buf = torch.empty((*lead, bucket.elems), dtype=stage_dtype, device=device)
    for s in bucket.segments:
        if s.size:
            piece = flat_leaves[s.leaf][..., s.start:s.start + s.size]
            buf[..., s.offset:s.offset + s.size].copy_(  # XLA's cast (core/fpisa.py)
                fpisa.to_packed(piece, fpisa.FMT_OF_DTYPE[stage_dtype]))
        if s.span > s.size:
            buf[..., s.offset + s.size:s.offset + s.span].zero_()
    return buf


def unpack_bucket(bucket: Bucket, out: torch.Tensor, pieces: dict) -> None:
    """Scatter an aggregated bucket buffer back into per-leaf piece lists."""
    for s in bucket.segments:
        if s.size:
            pieces[s.leaf].append((s.start, out[s.offset:s.offset + s.size]))


# ---------------------------------------------------------------------------
# per-bucket dispatch: split-phase pipeline (registry hooks) / generic call
# ---------------------------------------------------------------------------


def _stream_buckets(plan: BucketPlan, flat_leaves: dict, cfg: AggConfig,
                    pack_fn, phases_for, generic_fn) -> dict:
    """Double-buffered dispatch: for each bucket the host issues
        encode(i) -> [finish(i-1)] -> collective(i)
    so the decode of the in-flight bucket and the encode of the next one sit
    between consecutive collective launches, and the encode of bucket i
    runs while the collective of bucket i-1 is in flight.

    ``pack_fn(bucket, stage_dtype)`` assembles the wire buffer;
    ``phases_for(bucket)`` returns (encode, collect, finish) for split-phase
    pipelined strategies or None to dispatch through the one-shot
    ``generic_fn(buffer)`` with the same interleaving. Returns the
    {leaf index: [(start, aggregated piece), ...]} map."""
    pieces: dict[int, list] = {i: [] for i in flat_leaves}
    inflight = None  # (bucket, state, finish_fn or None)

    def land(entry):
        bucket, state, finish = entry
        with _trace.span("bucketer.finish", phase="finish",
                         bucket=bucket.index, elems=bucket.elems,
                         group=bucket.group) as sp:
            out = finish(state) if finish is not None else state
            sp.sync(out)
        unpack_bucket(bucket, out, pieces)

    for bucket in plan.buckets:
        phases = phases_for(bucket)
        if phases is not None:
            encode, collect, finish = phases
            with _trace.span("bucketer.encode", phase="encode",
                             bucket=bucket.index, elems=bucket.elems,
                             group=bucket.group) as sp:
                buf = pack_fn(bucket, _stage_dtype(cfg, bucket.group))
                state = encode(buf)
                sp.sync(state)
            if inflight is not None:
                land(inflight)
            with _trace.span("bucketer.collective", phase="collective",
                             bucket=bucket.index, elems=bucket.elems,
                             group=bucket.group) as sp:
                collected = collect(state)
                sp.sync(collected)
            inflight = (bucket, collected, finish)
        else:
            with _trace.span("bucketer.dispatch", phase="dispatch",
                             bucket=bucket.index, elems=bucket.elems,
                             group=bucket.group) as sp:
                buf = pack_fn(bucket, _stage_dtype(cfg, bucket.group))
                out = generic_fn(buf)
                sp.sync(out)
            if inflight is not None:
                land(inflight)
            inflight = (bucket, out, None)
    if inflight is not None:
        land(inflight)
    return pieces


def _reassemble(leaves, unflatten, results: dict, pieces: dict, shape_of=lambda l: l.shape):
    for i, leaf in enumerate(leaves):
        if i in results:
            continue
        shape = shape_of(leaf)
        ps = sorted(pieces[i], key=lambda t: t[0])
        if len(ps) == 1:
            flat = ps[0][1].to(leaf.dtype)
        else:
            flat = torch.empty(math.prod(shape), dtype=leaf.dtype, device=leaf.device)
            for start, piece in ps:
                flat[start:start + piece.shape[0]].copy_(piece)
        results[i] = flat.reshape(shape)
    return unflatten([results[i] for i in range(len(leaves))])


def bucketed_allreduce_tree(tree, group, cfg: AggConfig):
    """Aggregate a gradient tree through fixed-size streamed wire buckets
    with double-buffered dispatch (``_stream_buckets``). Strategies exposing
    split-phase hooks on their registry spec (``flat_phases`` /
    ``hier_phases``) pipeline encode/collective/decode; everything else (and
    chunked dispatch) goes through the one-shot facade path with the same
    interleaving. ``group`` is what ``Aggregator`` holds: a process group,
    None, or a (pod_group, data_group) pair."""
    leaves, unflatten = _agg.tree_flatten(tree)
    if not leaves:
        return tree
    inner = dataclasses.replace(cfg, bucket_bytes=0)
    plan = plan_for_config(leaves, cfg)

    results: dict[int, torch.Tensor] = {}
    for i in plan.passthrough:
        results[i] = _agg._dispatch(leaves[i], group, inner)

    planned = {s.leaf for b in plan.buckets for s in b.segments}
    flat_leaves = {i: leaves[i].reshape(-1) for i in planned}
    if not planned:
        return _reassemble(leaves, unflatten, results, {})
    device = leaves[min(planned)].device

    spec = _agg.get_strategy(cfg.strategy)
    hier = isinstance(group, tuple) and spec.hier_phases is not None
    pipelined = not cfg.chunk_elems and (
        spec.hier_phases is not None if hier else spec.flat_phases is not None)
    backend = _agg.resolve_backend(cfg.backend, device)
    flat_phases = None

    def phases_for(bucket):
        nonlocal flat_phases
        if not pipelined:
            return None
        if hier:
            pod_group, data_group = group
            return spec.hier_phases(data_group, pod_group, cfg, backend,
                                    stripe=bucket.index)
        if flat_phases is None:
            flat_phases = spec.flat_phases(group, cfg, backend)
        return flat_phases

    pieces = _stream_buckets(
        plan, flat_leaves, cfg,
        lambda bucket, dt: pack_bucket(bucket, flat_leaves, dt, device),
        phases_for,
        lambda buf: _agg._dispatch(buf, group, inner))
    return _reassemble(leaves, unflatten, results, pieces)


def bucketed_stacked_allreduce_tree(tree, group, cfg: AggConfig):
    """``bucketed_allreduce_tree`` for per-logical-worker gradient stacks:
    every leaf carries a leading worker axis of size k and the reduction
    runs over that axis and the group (core/allreduce.py, stacked section).

    The plan is built from the PER-WORKER leaf shapes (leading axis
    dropped), so the wire layout (block alignment, bucket cuts, dispatch
    order) is the unstacked plan of the same tree, identical for every k:
    after a failure the survivors re-plan for their new k without moving a
    block boundary. Each bucket is packed as one (k, elems) buffer; it comes
    back reduced (1-D) and unpacks as in the unstacked path."""
    leaves, unflatten = _agg.tree_flatten(tree)
    if not leaves:
        return tree
    k = leaves[0].shape[0]
    inner = dataclasses.replace(cfg, bucket_bytes=0)
    per_worker = [torch.empty(l.shape[1:], dtype=l.dtype, device="meta") for l in leaves]
    plan = plan_for_config(per_worker, cfg)

    results: dict[int, torch.Tensor] = {}
    for i in plan.passthrough:
        results[i] = _agg._dispatch_stacked(leaves[i], group, inner)

    def shape_of(leaf):
        return leaf.shape[1:]

    planned = {s.leaf for b in plan.buckets for s in b.segments}
    flat_leaves = {i: leaves[i].reshape(k, -1) for i in planned}
    if not planned:
        return _reassemble(leaves, unflatten, results, {}, shape_of)
    device = leaves[min(planned)].device

    spec = _agg.get_strategy(cfg.strategy)
    backend = _agg.resolve_backend(cfg.backend, device)
    phases = None

    def phases_for(bucket):
        nonlocal phases
        if spec.stacked_phases is None:
            return None
        if phases is None:
            phases = spec.stacked_phases(group, cfg, backend, k)
        return phases

    pieces = _stream_buckets(
        plan, flat_leaves, cfg,
        lambda bucket, dt: pack_bucket(bucket, flat_leaves, dt, device),
        phases_for,
        lambda buf: _agg._dispatch_stacked(buf, group, inner))
    return _reassemble(leaves, unflatten, results, pieces, shape_of)
