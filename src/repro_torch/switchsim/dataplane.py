"""Vectorized multi-pipeline FPISA switch dataplane (port of
``repro.switchsim.dataplane``).

State model
-----------
A dataplane is ``num_pipelines`` independent ingress pipelines, each with
``2 * num_slots`` physical aggregation slots (SwitchML's double pool: a
completed slot keeps re-serving its cached result for a full window before
being recycled). All per-slot state is stacked into tensors over the global
slot axis ``G = num_pipelines * 2 * num_slots``: the (G, E) int32 FPISA
accumulator planes, the (G, W) worker bitmap (idempotence), the owning
chunk and job, the cached result, and the round of the last owner touch.
Chunk ``c`` of job ``j`` is striped across pipelines (``pipeline = c % P``)
and wraps over the job's quota region of that pipeline (``slot_of_tenant``).

Batched ingest
--------------
``ingest_batch`` applies a batch of B packets with per-slot sequential
semantics (FPISA addition is order-dependent; different slots proceed in
parallel): packets are stable-sorted by slot, each packet's within-slot rank
becomes its round, and a (G, rounds) rank table holds at most one packet per
slot per round. Each round is one vectorized pass of the slot state machine
over all G slots (stale drop / claim + reset / bitmap-gated FPISA add /
completion + delayed renormalization / cached-result re-serve). Packets past
``rounds`` are deferred; ``BatchedDataplane`` resubmits them first.

It runs as torch operations on the state's device: on the card, the slot
state stays in device memory between calls, each call uploads its packets
once and brings ``ready``, ``results``, ``accepted`` and ``deferred`` back
once, and nothing in the round loop waits on the device. Where the JAX
version's idioms do not carry over:

* ``lax.scan`` over the table's columns is a Python loop over them; the
  table is built on the device (``_rank_table``).
* ``lax.cond(jnp.any(...))`` (renormalize on completion, the result scatter)
  cannot become ``if t.any():``, which would wait on the card every round.
  Both branches' work is done every round and ``torch.where`` / the spare
  scatter row select the result, so the bits are the same. The cost: one
  (G, E) renormalization and one (G, E) row scatter per round, also on the
  rounds where no slot completes (most of them: completion needs rank W-1).
* ``.at[idx].set(..., mode="drop")`` with the out-of-range index ``b`` is
  ``index_put_`` into a buffer with one spare row ``b``, sliced off after
  the loop. A round holds at most one packet per slot and each packet sits
  in one table cell, so the selected lanes' indices never collide (only the
  spare row takes several writes, and it is discarded).
* ``jnp.argsort`` is stable: ``torch.argsort(stable=True)``;
  ``lax.associative_scan(jnp.maximum)`` is ``torch.cummax``.
* The per-tenant counter scatter-adds are one ``index_put_(accumulate=True)``
  on the int32 (J, counters) plane per round (the victim's ``preempted`` to
  the owner's row); ``segment_sum`` over pipelines is a sum over the (P,
  2 * num_slots) view of the slot axis. All of these are allowed under
  deterministic algorithms (``runtime.elastic.reproducible``).
* The FPISA register adds wrap in two's complement: ``core/fpisa.py``'s.

``NumpyDataplane`` is the per-packet numpy mirror with the same semantics
(the ``switch_emu`` strategy and the shared-dataplane registry run it on the
host); ``run_aggregation`` drives either, or the per-packet
``core.switch.FpisaSwitch``, over an unreliable fabric with the reference's
seeded RNG stream, so for the same seed all of them and the reference give
the same bits and counters (tests/test_torch_dataplane.py).

Pipeline model, stats, worker-failure reclamation and multi-tenancy are the
reference's (its module doc has the full account): ``recirculations`` per
pipeline (the ``full`` add costs one per accepted packet); ``stale`` counts
retransmissions for a recycled slot apart from bitmap ``duplicates``;
``reclaim_worker(w, job)`` drops w from job's live set and resets only the
job's in-flight slots; tenants get a quota of logical slots per pipeline, a
weight for the stale-slot takeover lottery and a priority for preempting a
stale in-flight window (charged to the victim); a slot is stale once no
owner packet touched it for ``stale_after`` driver rounds, and a fresh
foreign slot always denies the claim.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import trace as _trace
from repro_torch.core import fpisa
from repro_torch.switchsim import COUNTERS, SLOT_STATE_FIELDS, npfpisa

_I_PACKETS, _I_DUP, _I_STALE, _I_OVERWRITE, _I_OVERFLOW, _I_RECLAIMED, \
    _I_DENIED, _I_PREEMPTED = range(len(COUNTERS))

# modulus/multipliers of the takeover lottery hash: a prime < 2**16 keeps
# every intermediate below 2**25, so the torch (int32) and numpy planes
# compute the identical value with no overflow divergence
_LOTTERY_MOD = 65521
_LOTTERY_A, _LOTTERY_B, _LOTTERY_C = 257, 193, 11


@dataclasses.dataclass(frozen=True)
class DataplaneConfig:
    """Static shape/semantics of a dataplane (frozen, hashable)."""

    num_workers: int
    num_slots: int = 8  # logical slots per pipeline (physical = 2x: double pool)
    elems_per_packet: int = 256
    fmt_name: str = "fp32"
    variant: str = "fpisa_a"  # fpisa_a | full
    num_pipelines: int = 1
    # max per-slot packets applied per ingest call; 0 -> 2 * num_workers
    # (the worst case one driver round can produce under the window
    # discipline: W retransmissions of the completed chunk + W first packets
    # of the chunk recycling the slot). Overflow packets are deferred.
    rounds_per_call: int = 0
    # --- multi-tenancy ---
    num_jobs: int = 1
    # per-job quota of logical slots per pipeline; None -> num_slots each
    # (fully shared pool). Quotas summing to num_slots tile the pool into
    # disjoint per-job partitions.
    job_slots: tuple[int, ...] | None = None
    # per-job QoS: priority orders in-flight preemption; weight biases the
    # stale-slot takeover lottery. None -> all equal.
    job_priorities: tuple[int, ...] | None = None
    job_weights: tuple[int, ...] | None = None
    # per-job port count (workers); None -> num_workers each. Job j's worker
    # ids live in [0, job_workers[j]); the rest are born non-live for it.
    job_workers: tuple[int, ...] | None = None
    # driver rounds without an owner-job touch before a slot counts as stale
    # (abandoned) and becomes claimable cross-job
    stale_after: int = 4

    @property
    def fmt(self):
        return fpisa.FORMATS[self.fmt_name]

    def _job_tuple(self, field, default) -> tuple[int, ...]:
        val = field if field is not None else (default,) * self.num_jobs
        assert len(val) == self.num_jobs, (val, self.num_jobs)
        return tuple(int(v) for v in val)

    @property
    def quotas(self) -> tuple[int, ...]:
        q = self._job_tuple(self.job_slots, self.num_slots)
        assert all(1 <= v <= self.num_slots for v in q), q
        return q

    @property
    def priorities(self) -> tuple[int, ...]:
        return self._job_tuple(self.job_priorities, 0)

    @property
    def weights(self) -> tuple[int, ...]:
        w = self._job_tuple(self.job_weights, 1)
        assert all(v >= 1 for v in w), w
        return w

    @property
    def ports(self) -> tuple[int, ...]:
        p = self._job_tuple(self.job_workers, self.num_workers)
        assert all(1 <= v <= self.num_workers for v in p), p
        return p

    @property
    def job_bases(self) -> tuple[int, ...]:
        """Logical-slot origin of each job's quota region (quotas tiling
        num_slots -> disjoint regions; full quotas -> everyone at 0)."""
        q, out, acc = self.quotas, [], 0
        for j in range(self.num_jobs):
            out.append(acc % self.num_slots)
            acc += q[j]
        return tuple(out)

    def job_window(self, job: int = 0) -> int:
        """Per-job streaming-window depth: its quota across all pipelines."""
        return self.quotas[job] * self.num_pipelines

    @property
    def physical_slots_per_pipeline(self) -> int:
        return 2 * self.num_slots

    @property
    def total_slots(self) -> int:
        return self.num_pipelines * self.physical_slots_per_pipeline

    @property
    def window(self) -> int:
        """Streaming-window depth in chunks (self-clocking: a worker may send
        chunk c only once it holds the result of c - window)."""
        return self.num_slots * self.num_pipelines

    @property
    def rounds(self) -> int:
        return self.rounds_per_call or 2 * self.num_workers


class DataplaneState(NamedTuple):
    exp: torch.Tensor  # (G, E) int32 accumulator exponent plane
    man: torch.Tensor  # (G, E) int32 accumulator mantissa plane
    seen: torch.Tensor  # (G, W) bool worker bitmap
    slot_chunk: torch.Tensor  # (G,) int32 chunk owning the slot; -1 = unclaimed
    result: torch.Tensor  # (G, E) packed-FP cached broadcast payload
    result_valid: torch.Tensor  # (G,) bool
    counters: torch.Tensor  # (J, len(COUNTERS)) int32 per-job counters
    recirc: torch.Tensor  # (P,) int32 per-pipeline recirculation counter
    live: torch.Tensor  # (J, W) bool per-job live worker (port) set
    slot_job: torch.Tensor  # (G,) int32 owning job; -1 = never claimed
    last_touch: torch.Tensor  # (G,) int32 round of the last owner-job touch


# the state layout IS the shared contract (the numpy mirror's attributes
# are checked the same way in its __init__)
assert DataplaneState._fields == SLOT_STATE_FIELDS, (
    DataplaneState._fields, SLOT_STATE_FIELDS)


def init_state(cfg: DataplaneConfig, device) -> DataplaneState:
    g, e, dev = cfg.total_slots, cfg.elems_per_packet, torch.device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    ports = torch.tensor(cfg.ports, device=dev)
    return DataplaneState(
        exp=torch.zeros((g, e), **i32),
        man=torch.zeros((g, e), **i32),
        seen=torch.zeros((g, cfg.num_workers), dtype=torch.bool, device=dev),
        slot_chunk=torch.full((g,), -1, **i32),
        result=torch.zeros((g, e), dtype=fpisa.PACKED_DTYPE[cfg.fmt_name], device=dev),
        result_valid=torch.zeros((g,), dtype=torch.bool, device=dev),
        counters=torch.zeros((cfg.num_jobs, len(COUNTERS)), **i32),
        recirc=torch.zeros((cfg.num_pipelines,), **i32),
        live=torch.arange(cfg.num_workers, device=dev)[None, :] < ports[:, None],
        slot_job=torch.full((g,), -1, **i32),
        last_touch=torch.zeros((g,), **i32),
    )


def reclaim_dead_worker(state: DataplaneState, worker: int, job: int = 0, *,
                        cfg: DataplaneConfig) -> DataplaneState:
    """Remove ``worker`` from ``job``'s live set and reset every in-flight
    slot **owned by that job** (module doc). Other tenants' slots, live sets
    and counters are untouched. Idempotent: reclaiming an already-dead
    worker is a no-op. Nothing waits on the device."""
    was_live = state.live[job, worker]
    inflight = (was_live & (state.slot_chunk >= 0) & ~state.result_valid
                & (state.slot_job == job))
    live = state.live.clone()
    live[job, worker] = False
    counters = state.counters.clone()
    counters[job, _I_RECLAIMED] += inflight.sum(dtype=torch.int32)
    return state._replace(
        exp=torch.where(inflight[:, None], 0, state.exp),
        man=torch.where(inflight[:, None], 0, state.man),
        seen=torch.where(inflight[:, None], False, state.seen),
        live=live,
        counters=counters,
    )


def slot_of(cfg: DataplaneConfig, chunks):
    """Global slot id for each chunk id (pipeline striping + double pool) —
    the single-tenant mapping, identical to ``slot_of_tenant`` with job 0 and
    a full quota."""
    pipe = chunks % cfg.num_pipelines
    slot = (chunks // cfg.num_pipelines) % cfg.physical_slots_per_pipeline
    return pipe * cfg.physical_slots_per_pipeline + slot


def _table(values, like, xp):
    """A per-job constant tuple as an array indexable by ``like``'s jobs."""
    if xp is torch:
        return torch.tensor(values, device=like.device)
    return np.asarray(values)


def slot_of_tenant(cfg: DataplaneConfig, jobs, chunks, xp=np):
    """Global slot id under per-job quota striping: job j's chunk stream
    wraps over the ``2 * quotas[j]`` physical slots starting at
    ``2 * job_bases[j]`` of its pipeline. With a full quota (base 0) this is
    exactly ``slot_of`` — the single-tenant parity anchor. ``xp`` is ``np``
    (numpy arrays) or ``torch`` (tensors, on their device)."""
    phys = cfg.physical_slots_per_pipeline
    q = _table(cfg.quotas, jobs, xp)[jobs]
    base = _table(cfg.job_bases, jobs, xp)[jobs]
    pipe = chunks % cfg.num_pipelines
    idx = (chunks // cfg.num_pipelines) % (2 * q)
    return pipe * phys + (2 * base + idx) % phys


def lottery_pref(cfg: DataplaneConfig, now, xp=np, device=None):
    """(G,) preferred tenant per slot for round ``now`` — the weighted
    admission lottery for stale-slot takeovers. A pure function of
    (slot, round, weights): order-free within a round and bit-identical
    across the torch and numpy dataplanes (int32-safe modular hash)."""
    weights = cfg.weights
    cumw = np.cumsum(weights, dtype=np.int32)
    if xp is torch:
        g = torch.arange(cfg.total_slots, dtype=torch.int32, device=device)
    else:
        g = np.arange(cfg.total_slots, dtype=np.int32)
    h = ((g % _LOTTERY_MOD) * _LOTTERY_A + (now % _LOTTERY_MOD) * _LOTTERY_B
         + _LOTTERY_C) % _LOTTERY_MOD
    if xp is torch:
        return torch.searchsorted(torch.tensor(cumw, device=device), h % sum(weights),
                                  right=True).to(torch.int32)
    return np.searchsorted(cumw, h % sum(weights), side="right").astype(np.int32)


def _rank_table(key: torch.Tensor, valid: torch.Tensor, num_keys: int, rounds: int):
    """Scatter packet indices into a (num_keys, rounds) table such that column
    r holds (at most) the r-th packet, in batch order, of every key; built
    on ``key``'s device without waiting on it.

    Returns (table int32 with -1 for empty cells, deferred bool mask over the
    batch marking packets whose within-key rank >= rounds). Each packet
    index appears in at most one cell."""
    b, dev = key.shape[0], key.device
    key = torch.where(valid, key, num_keys)  # invalid -> sentinel, dropped below
    order = torch.argsort(key, stable=True)  # stable: batch order within a key
    ks = key[order]
    first = torch.ones(b, dtype=torch.bool, device=dev)
    first[1:] = ks[1:] != ks[:-1]
    ar = torch.arange(b, device=dev)
    seg_start = torch.cummax(torch.where(first, ar, 0), 0).values
    rank = ar - seg_start

    fits = (ks < num_keys) & (rank < rounds)
    # row num_keys is the spare row of the lanes that do not fit (mode="drop")
    table = torch.full((num_keys + 1, rounds), -1, dtype=torch.int32, device=dev)
    table.index_put_((torch.where(fits, ks, num_keys), torch.where(fits, rank, 0)),
                     order.to(torch.int32))
    deferred = torch.zeros(b, dtype=torch.bool, device=dev)
    deferred[order] = (ks < num_keys) & (rank >= rounds)  # order is a permutation
    return table[:num_keys], deferred


# counter columns of the per-round scatter-add, in the order of its values
_COUNTER_COLS = (_I_PACKETS, _I_DUP, _I_STALE, _I_OVERWRITE, _I_OVERFLOW, _I_DENIED,
                 _I_PREEMPTED)


def ingest_batch(state: DataplaneState, workers, chunks, payloads, valid,
                 jobs=None, now: int = 0, *, cfg: DataplaneConfig,
                 rounds: int | None = None):
    """Apply a batch of packets to the dataplane (see module doc).

    Args (tensors on the state's device):
      state:    DataplaneState.
      workers:  (B,) integer worker ids in [0, num_workers).
      chunks:   (B,) integer chunk ids.
      payloads: (B, E) float payloads.
      valid:    (B,) bool lane mask (padding lanes are ignored).
      jobs:     (B,) integer tenant ids in [0, num_jobs); None -> all job 0.
      now:      the driver round (the staleness clock), a Python int.

    Returns ``(state, ready, results, accepted, deferred)`` where ``ready``
    marks packets answered with a broadcast payload (slot completion or
    idempotent re-serve of a completed chunk), ``results`` holds those
    payloads in the format's dtype, ``accepted`` marks packets whose
    contribution was added (first arrival of a (worker, chunk)), and
    ``deferred`` marks packets not processed this call (per-slot rank
    overflow; resubmit in order)."""
    g, w_n, b = cfg.total_slots, cfg.num_workers, workers.shape[0]
    dev = state.exp.device
    rounds = rounds or cfg.rounds
    fmt = cfg.fmt
    add = fpisa.fpisa_a_add if cfg.variant == "fpisa_a" else fpisa.fpisa_add_full
    planes = fpisa.encode(payloads, fmt)
    workers = workers.long()
    chunks = chunks.to(torch.int32)
    if jobs is None:
        jobs = torch.zeros(b, dtype=torch.long, device=dev)
    jobs = jobs.long().clamp(0, cfg.num_jobs - 1)

    table, deferred = _rank_table(slot_of_tenant(cfg, jobs, chunks.long(), torch), valid,
                                  g, rounds)
    slots = torch.arange(g, device=dev)
    ports = torch.arange(w_n, device=dev)
    prio = torch.tensor(cfg.priorities, device=dev)
    pref = lottery_pref(cfg, now, torch, dev)  # constant across this call's rounds
    cols = torch.tensor(_COUNTER_COLS, device=dev)[:, None].expand(-1, g)

    (exp, man, seen, slot_chunk, result, rvalid, counters, recirc, live, slot_job,
     last_touch) = state
    # one spare row b takes the lanes that serve / add nothing (module doc)
    ready = torch.zeros(b + 1, dtype=torch.bool, device=dev)
    results = torch.zeros((b + 1, cfg.elems_per_packet), dtype=result.dtype, device=dev)
    accepted = torch.zeros(b + 1, dtype=torch.bool, device=dev)
    true = torch.ones((), dtype=torch.bool, device=dev)

    for r in range(rounds):  # lax.scan over the table's columns
        pidx = table[:, r]
        active = pidx >= 0
        pi = torch.where(active, pidx, 0).long()
        wk, ck, jb = workers[pi], chunks[pi], jobs[pi]
        inp = fpisa.Planes(planes.exp[pi], planes.man[pi])

        cur, owner = slot_chunk, slot_job
        owner_c = owner.long().clamp(0, cfg.num_jobs - 1)
        # packets from reclaimed (dead) workers are dropped like stale ones
        port_live = live[jb, wk]
        act = active & port_live
        is_dead = active & ~port_live
        free = cur < 0
        same = act & (free | (owner == jb))
        cross = act & ~free & (owner != jb)

        # same-tenant path: the classic single-tenant slot machine
        s_stale = same & (cur > ck)
        is_new = same & (cur < ck)  # includes free slots (cur = -1)
        s_dup = same & (cur == ck)

        # cross-tenant path: fresh slots deny; stale slots are claimable by
        # takeover (completed: weighted lottery, or higher priority) or
        # preemption (in-flight: higher priority, or equal priority winning
        # the lottery)
        slot_stale = (now - last_touch) >= cfg.stale_after
        higher = prio[jb] > prio[owner_c]
        equal = prio[jb] == prio[owner_c]
        takeover = cross & rvalid & slot_stale & (higher | (pref == jb))
        preempt = cross & ~rvalid & slot_stale & (higher | (equal & (pref == jb)))
        denied = cross & ~(takeover | preempt)

        claim = is_new | takeover | preempt
        is_stale = is_dead | s_stale
        proceed = claim | s_dup

        # claim: reset the slot for the new (job, chunk) ownership
        seen = torch.where(claim[:, None], False, seen)
        exp = torch.where(claim[:, None], 0, exp)
        man = torch.where(claim[:, None], 0, man)
        rvalid = torch.where(claim, False, rvalid)
        slot_chunk = torch.where(claim, ck, cur)
        slot_job = torch.where(claim, jb.to(torch.int32), owner)
        # owner-job activity refreshes the staleness clock (claims, adds and
        # re-serve dups); denied/stale/dead packets do not
        last_touch = torch.where(proceed, now, last_touch)

        already = seen[slots, torch.where(proceed, wk, 0)]
        is_dup = proceed & already
        do_add = proceed & ~already

        newp, addst = add(fpisa.Planes(exp, man), inp, fmt)
        exp = torch.where(do_add[:, None], newp.exp, exp)
        man = torch.where(do_add[:, None], newp.man, man)
        seen = seen | (do_add[:, None] & (ports[None, :] == wk[:, None]))
        # completion requires every LIVE worker's bit of the packet's own
        # tenant (dead/unported bits are waived)
        complete = do_add & torch.all(seen | ~live[jb], dim=1)

        # lax.cond(any(complete)) -> computed every round, selected by where
        result = torch.where(complete[:, None],
                             fpisa.renormalize(fpisa.Planes(exp, man), fmt), result)
        rvalid = rvalid | complete

        serve = complete | (is_dup & rvalid)
        # .at[where(m, pi, b)].set(mode="drop") -> the spare row b (module doc)
        serve_at = torch.where(serve, pi, b)
        ready.index_put_((serve_at,), true)
        results.index_put_((serve_at,), result)
        accepted.index_put_((torch.where(do_add, pi, b),), true)

        # per-job counters: commutative scatter-adds keyed by the packet's
        # tenant (preempted is charged to the VICTIM, the slot's owner)
        vals = torch.stack([
            do_add, is_dup, is_stale,
            (addst.overwrite & do_add[:, None]).sum(1, dtype=torch.int32),
            (addst.overflow & do_add[:, None]).sum(1, dtype=torch.int32),
            denied, preempt]).to(torch.int32)
        rows = torch.cat([jb[None].expand(6, -1), owner_c[None]])
        counters = counters.index_put((rows, cols), vals, accumulate=True)
        # RSAW full-add costs one recirculation pass per accepted packet;
        # a pipeline's slots are contiguous on the slot axis
        if cfg.variant == "full":
            recirc = recirc + do_add.view(cfg.num_pipelines, -1).sum(1, dtype=torch.int32)

    state = DataplaneState(exp, man, seen, slot_chunk, result, rvalid, counters, recirc,
                           live, slot_job, last_touch)
    return state, ready[:b], results[:b], accepted[:b], deferred


def _pow2ceil(n: int, floor: int = 1) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


class BatchedDataplane:
    """Host-side handle: owns the slot state on a device (the card unless
    the caller passes the CPU; without a card it raises), pads and submits
    numpy batches, resubmits deferred packets, and exposes ``stats``.

    As in the reference, batches are padded to one of two sizes (256 and
    ``max_batch``) and the per-slot round count is the power-of-two cover
    of the batch's largest slot occupancy, capped at ``cfg.rounds``.
    ``calls`` and ``rounds_run`` count the device calls and their rounds."""

    def __init__(self, cfg: DataplaneConfig, max_batch: int | None = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state = init_state(cfg, self.device)
        # largest batch one driver round can produce under the window
        # discipline (every worker's full in-flight window)
        self.max_batch = max_batch or min(
            _pow2ceil(cfg.num_workers * cfg.window), 8192)
        self._sizes = sorted({min(256, self.max_batch), self.max_batch})
        self.calls = 0
        self.rounds_run = 0

    def _pad_size(self, n: int) -> int:
        for s in self._sizes:
            if n <= s:
                return s
        return self.max_batch

    def ingest_batch(self, workers, chunks, payloads, jobs=None, now=0):
        """Process packets (numpy in/out). Returns (ready, results, accepted)
        aligned with the input batch; within-slot application order is the
        batch order, matching a sequential per-packet switch. ``jobs`` tags
        each packet with its tenant (None -> job 0); ``now`` is the driver's
        round clock for staleness aging."""
        cfg = self.cfg
        workers = np.asarray(workers, np.int32)
        chunks = np.asarray(chunks, np.int32)
        payloads = np.asarray(payloads, np.float32).reshape(len(workers), cfg.elems_per_packet)
        b = len(workers)
        jobs_np = np.zeros(b, np.int32) if jobs is None else np.asarray(jobs, np.int32)
        ready = np.zeros(b, bool)
        results = np.zeros((b, cfg.elems_per_packet), np.float32)
        accepted = np.zeros(b, bool)
        gids = np.asarray(slot_of_tenant(cfg, jobs_np.astype(np.int64),
                                         chunks.astype(np.int64)))
        queue = np.arange(b)
        while queue.size:
            cur, queue = queue[: self.max_batch], queue[self.max_batch:]
            n, bp = cur.size, self._pad_size(cur.size)
            occ = int(np.bincount(gids[cur]).max())
            rounds = min(_pow2ceil(occ), cfg.rounds)
            lanes = np.zeros((4, bp), np.int32)  # worker, chunk, job, valid
            lanes[0, :n], lanes[1, :n], lanes[2, :n] = workers[cur], chunks[cur], jobs_np[cur]
            lanes[3, :n] = 1
            pl = np.zeros((bp, cfg.elems_per_packet), np.float32)
            pl[:n] = payloads[cur]
            lanes_d = torch.from_numpy(lanes).to(self.device)
            self.state, rdy, res, acc, dfr = ingest_batch(
                self.state, lanes_d[0], lanes_d[1], torch.from_numpy(pl).to(self.device),
                lanes_d[3].bool(), lanes_d[2], int(now), cfg=cfg, rounds=rounds)
            self.calls += 1
            self.rounds_run += rounds
            flags = torch.stack([rdy, acc, dfr]).cpu().numpy()[:, :n]
            res = res[:n].float().cpu().numpy()
            rdy, acc, dfr = flags
            ready[cur[rdy]] = True
            results[cur[rdy]] = res[rdy]
            accepted[cur[acc]] = True
            # deferred packets (rank overflow) go back FIRST: they precede
            # everything not yet submitted in the original batch order
            if dfr.any():
                queue = np.concatenate([cur[dfr], queue])
        return ready, results, accepted

    def reclaim_worker(self, worker: int, job: int = 0):
        """Control-plane recovery: drop ``worker`` from ``job``'s live set and
        reset its parked in-flight slots (module doc). Survivor
        retransmissions resubmit the reset chunks from their shadow copies."""
        self.state = reclaim_dead_worker(self.state, worker, job, cfg=self.cfg)

    @property
    def stats(self) -> dict:
        """Switch-wide stats: per-job counters summed over tenants."""
        c = self.state.counters.sum(0).tolist()
        out = {name: int(c[i]) for i, name in enumerate(COUNTERS)}
        out["recirculations"] = self.state.recirc.tolist()
        return out

    @property
    def job_stats(self) -> list[dict]:
        """Per-tenant counters, one dict per job id."""
        c = self.state.counters.tolist()
        return [{name: int(c[j][i]) for i, name in enumerate(COUNTERS)}
                for j in range(self.cfg.num_jobs)]


class NumpyDataplane:
    """The dataplane as a per-packet numpy loop over ``npfpisa`` primitives,
    with the same slot semantics and ``ingest_batch`` interface as
    ``BatchedDataplane`` (the same bits and counters as it and as the
    reference's dataplanes; tests/test_torch_dataplane.py pins it). The
    ``switch_emu`` strategy and the shared-dataplane registry run it on the
    host. fp32 only."""

    def __init__(self, cfg: DataplaneConfig):
        assert cfg.fmt_name == "fp32", "numpy dataplane is fp32-only"
        self.cfg = cfg
        g, e = cfg.total_slots, cfg.elems_per_packet
        self._exp = np.zeros((g, e), np.int32)
        self._man = np.zeros((g, e), np.int32)
        self._seen = np.zeros((g, cfg.num_workers), bool)
        self._slot_chunk = np.full((g,), -1, np.int64)
        self._result = np.zeros((g, e), np.float32)
        self._result_valid = np.zeros((g,), bool)
        self._live = (np.arange(cfg.num_workers)[None, :]
                      < np.asarray(cfg.ports)[:, None])
        self._slot_job = np.full((g,), -1, np.int64)
        self._last_touch = np.zeros((g,), np.int64)
        self._counters = np.zeros((cfg.num_jobs, len(COUNTERS)), np.int64)
        self._recirc = [0] * cfg.num_pipelines
        # one `_`-prefixed attribute per shared slot-state field, so the
        # state layout cannot drift from the batched dataplane's silently
        missing = [f for f in SLOT_STATE_FIELDS
                   if not hasattr(self, f"_{f}")]
        assert not missing, f"NumpyDataplane missing mirror fields {missing}"

    @property
    def stats(self) -> dict:
        """Switch-wide stats: per-job counters summed over tenants."""
        c = self._counters.sum(axis=0)
        out = {name: int(c[i]) for i, name in enumerate(COUNTERS)}
        out["recirculations"] = list(self._recirc)
        return out

    @property
    def job_stats(self) -> list[dict]:
        """Per-tenant counters, one dict per job id."""
        return [{name: int(self._counters[j, i])
                 for i, name in enumerate(COUNTERS)}
                for j in range(self.cfg.num_jobs)]

    def reclaim_worker(self, worker: int, job: int = 0):
        """Same reclamation semantics as ``BatchedDataplane.reclaim_worker``:
        only slots owned by ``job`` are reset."""
        if not self._live[job, worker]:
            return
        self._live[job, worker] = False
        inflight = ((self._slot_chunk >= 0) & ~self._result_valid
                    & (self._slot_job == job))
        self._exp[inflight] = 0
        self._man[inflight] = 0
        self._seen[inflight] = False
        self._counters[job, _I_RECLAIMED] += int(inflight.sum())

    def ingest_batch(self, workers, chunks, payloads, jobs=None, now=0):
        cfg, F = self.cfg, npfpisa
        workers = np.asarray(workers, np.int64)
        chunks = np.asarray(chunks, np.int64)
        payloads = np.asarray(payloads, np.float32).reshape(
            len(workers), cfg.elems_per_packet)
        b = len(workers)
        jobs = (np.zeros(b, np.int64) if jobs is None
                else np.asarray(jobs, np.int64))
        add = F.fpisa_a_add if cfg.variant == "fpisa_a" else F.fpisa_add_full
        gids = np.asarray(slot_of_tenant(cfg, jobs, chunks))
        pref = lottery_pref(cfg, int(now), np)
        prio = cfg.priorities
        in_exp, in_man = F.encode(payloads)
        ready = np.zeros(b, bool)
        results = np.zeros((b, cfg.elems_per_packet), np.float32)
        accepted = np.zeros(b, bool)
        ct = self._counters
        for i in range(b):
            g, w, c, j = int(gids[i]), int(workers[i]), int(chunks[i]), int(jobs[i])
            if not self._live[j, w]:
                ct[j, _I_STALE] += 1
                continue
            cur, owner = self._slot_chunk[g], int(self._slot_job[g])
            if cur >= 0 and owner != j:
                # cross-tenant: deny fresh slots; stale ones fall to the
                # takeover lottery / priority preemption (ingest_batch's
                # round loop applies these rules lane-wise)
                slot_stale = (int(now) - self._last_touch[g]) >= cfg.stale_after
                higher = prio[j] > prio[owner]
                equal = prio[j] == prio[owner]
                if self._result_valid[g]:
                    allowed = slot_stale and (higher or pref[g] == j)
                else:
                    allowed = slot_stale and (higher or (equal and pref[g] == j))
                    if allowed:
                        ct[owner, _I_PREEMPTED] += 1
                if not allowed:
                    ct[j, _I_DENIED] += 1
                    continue
                claim = True
            elif cur > c:
                ct[j, _I_STALE] += 1
                continue
            else:
                claim = cur < c
            if claim:  # reset the slot for the new (job, chunk) ownership
                self._slot_chunk[g] = c
                self._slot_job[g] = j
                self._seen[g] = False
                self._exp[g] = 0
                self._man[g] = 0
                self._result_valid[g] = False
            self._last_touch[g] = int(now)  # owner-job activity: not stale
            if self._seen[g, w]:
                ct[j, _I_DUP] += 1  # idempotent: do NOT re-add
                if self._result_valid[g]:
                    ready[i] = True
                    results[i] = self._result[g]
                continue
            self._seen[g, w] = True
            ct[j, _I_PACKETS] += 1
            e2, m2, over, ovf = add(self._exp[g], self._man[g], in_exp[i], in_man[i])
            self._exp[g], self._man[g] = e2, m2
            ct[j, _I_OVERWRITE] += int(over.sum())
            ct[j, _I_OVERFLOW] += int(ovf.sum())
            accepted[i] = True
            if cfg.variant == "full":
                self._recirc[g // cfg.physical_slots_per_pipeline] += 1
            if (self._seen[g] | ~self._live[j]).all():
                self._result[g] = F.renormalize(self._exp[g], self._man[g])
                self._result_valid[g] = True
                ready[i] = True
                results[i] = self._result[g]
        return ready, results, accepted


def run_aggregation(
    switch,
    worker_vectors: np.ndarray,
    drop_prob: float = 0.0,
    seed: int = 0,
    max_rounds: int = 10_000,
    record_arrivals: bool = False,
    fail_worker: int | None = None,
    fail_round: int | None = None,
    detect_rounds: int = 2,
    chunk_base: int = 0,
    job: int = 0,
    now_base: int = 0,
):
    """Batch-per-round all-reduce driver over an unreliable fabric.

    ``switch`` is a dataplane with ``ingest_batch`` (``BatchedDataplane``:
    one device call per round, or ``NumpyDataplane``) getting every eligible
    (worker, chunk) packet of a round that survives the i.i.d. request drop,
    or any object with a per-packet ``.ingest`` (``core.switch.FpisaSwitch``:
    the same round-synchronous schedule, one packet at a time). All consume
    the seeded RNG identically (request drops drawn as one vector per round,
    per-worker result-delivery drops drawn per completion in packet order),
    so for identical seeds they are **bit-identical** end to end, and equal
    to the reference's.

    Eligibility is snapshotted at round start: worker w may send chunk c iff
    it lacks c's result and holds the result of c - window (SwitchML's
    self-clocked streaming window, which makes slot recycling safe).

    Returns the aggregated (N,) vector; with ``record_arrivals`` (dataplanes
    with ``ingest_batch``) also a {chunk: [workers in acceptance order]}
    dict for replaying the exact switch-arrival order through
    ``fpisa_sum_sequential`` or K6.

    Fault injection: with ``fail_worker``/``fail_round`` set, that worker
    crashes at the start of that round — it stops sending, and no result
    delivery is owed to it. ``detect_rounds`` rounds later the control plane's
    heartbeat timeout fires and ``switch.reclaim_worker`` frees its parked
    slots; the survivors' retransmissions (their shadow copies) then
    resubmit the reset chunks and the aggregation completes as a live-worker
    sum. Chunks whose slots completed before the death keep the dead worker's
    contribution (their cached results are re-served unchanged).

    ``chunk_base`` offsets the on-wire chunk ids so one switch can carry many
    consecutive calls (e.g. one per training step) without its slot state
    going stale: chunk ids stay monotonic across calls, which is exactly the
    SwitchML recycling discipline.

    ``job`` tags every packet with that tenant id on a multi-tenant switch
    (this driver streams ONE job's traffic; ``tenancy.run_multitenant``
    interleaves several). ``now_base`` offsets the staleness clock the same
    way ``chunk_base`` offsets chunk ids, so consecutive calls against a
    shared switch keep aging the other tenants' slots; the clock reached is
    left on ``switch.last_now``.
    """
    cfg = switch.cfg
    w, n = worker_vectors.shape
    ports = getattr(cfg, "ports", None)
    assert w == (ports[job] if ports is not None else cfg.num_workers)
    e = cfg.elems_per_packet
    if hasattr(cfg, "job_window"):
        window = cfg.job_window(job)
    else:
        window = cfg.num_slots * getattr(cfg, "num_pipelines", 1)
    pad = (-n) % e
    vecs = np.pad(worker_vectors, ((0, 0), (0, pad))).astype(np.float32)
    nchunks = vecs.shape[1] // e
    vecs3 = vecs.reshape(w, nchunks, e)
    rng = np.random.default_rng(seed)
    batched = hasattr(switch, "ingest_batch")

    out = np.zeros((nchunks, e), np.float32)
    have_result = np.zeros((w, nchunks), bool)
    arrivals: dict[int, list[int]] = {}

    sp = _trace.span("switchsim.run_aggregation", phase="switch",
                     workers=w, nchunks=nchunks, job=job,
                     batched=batched, drop_prob=drop_prob)
    with sp:
        rnd = _drive_rounds(
            switch, vecs3, out, have_result, arrivals, rng,
            drop_prob=drop_prob, max_rounds=max_rounds, window=window,
            record_arrivals=record_arrivals, fail_worker=fail_worker,
            fail_round=fail_round, detect_rounds=detect_rounds,
            chunk_base=chunk_base, job=job, now_base=now_base,
            batched=batched)
        if sp:
            sp.tag(rounds=rnd + 1)
    switch.last_now = now_base + rnd  # staleness clock for the next caller
    flat = out.reshape(-1)[:n]
    if record_arrivals:
        return flat, arrivals
    return flat


def _drive_rounds(switch, vecs3, out, have_result, arrivals, rng, *,
                  drop_prob, max_rounds, window, record_arrivals,
                  fail_worker, fail_round, detect_rounds, chunk_base, job,
                  now_base, batched):
    """The round-synchronous loop of ``run_aggregation`` (the reference's RNG
    stream, split out so the driver's trace span wraps exactly the wire
    time). Returns the index of the last round."""
    w, nchunks, e = vecs3.shape
    reclaim_at: int | None = None
    for rnd in range(max_rounds):
        if fail_round is not None and rnd == fail_round and fail_worker is not None:
            # the worker crashes: it stops sending and is owed no delivery
            have_result[fail_worker, :] = True
            reclaim_at = rnd + detect_rounds  # heartbeat timeout fires then
        if reclaim_at is not None and rnd >= reclaim_at:
            switch.reclaim_worker(fail_worker, job)
            reclaim_at = None
        if have_result.all():
            break
        elig = ~have_result
        if nchunks > window:
            elig[:, window:] &= have_result[:, :-window]
        ws, cs = np.nonzero(elig)  # row-major: worker-major packet order
        keep = rng.random(ws.size) >= drop_prob
        ws, cs = ws[keep], cs[keep]
        if ws.size == 0:
            continue
        payloads = vecs3[ws, cs]
        if batched:
            ready, results, accepted = switch.ingest_batch(
                ws, cs + chunk_base, payloads,
                jobs=np.full(ws.size, job, np.int32), now=now_base + rnd)
            if record_arrivals:
                for i in np.nonzero(accepted)[0]:
                    arrivals.setdefault(int(cs[i]), []).append(int(ws[i]))
        else:
            from repro_torch.core import switch as legacy

            ready = np.zeros(ws.size, bool)
            results = np.zeros((ws.size, e), np.float32)
            for i in range(ws.size):
                res = switch.ingest(
                    legacy.Packet(int(ws[i]), int(cs[i]) + chunk_base, payloads[i]),
                    job=job, now=now_base + rnd)
                if res is not None:
                    ready[i] = True
                    results[i] = res.payload
        for i in np.nonzero(ready)[0]:
            c = int(cs[i])
            out[c] = results[i]
            # vectorized but stream-identical to per-worker rng.random()
            # calls guarded by `not have_result` (Generator.random(n) draws
            # the same sequence as n scalar draws)
            miss = np.nonzero(~have_result[:, c])[0]
            if miss.size:
                ok = rng.random(miss.size) >= drop_prob
                have_result[miss[ok], c] = True
    if not have_result.all():
        raise RuntimeError("aggregation did not complete within max_rounds")
    return rnd
