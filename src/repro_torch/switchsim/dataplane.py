"""The switch dataplane's numpy parts: per-packet FPISA slot semantics and
the batch-per-round all-reduce driver (port of the single-tenant numpy half
of ``repro.switchsim.dataplane``).

State model (as in the reference): ``num_pipelines`` ingress pipelines,
each with ``2 * num_slots`` physical aggregation slots (SwitchML's double
pool: a completed slot keeps re-serving its cached result for a full window
before being recycled). Chunk ``c`` is striped across pipelines (``pipeline
= c % P``) and lands in physical slot ``(c // P) % (2 * num_slots)`` of that
pipeline. Per slot: the FPISA accumulator planes, a worker bitmap
(idempotence), the owning chunk, the cached result.

``NumpyDataplane`` applies packets one at a time with the reference's slot
machine: stale drop, claim + reset, bitmap-gated FPISA add (``npfpisa``),
completion and delayed renormalization, cached-result re-serve and
dead-worker reclamation. ``run_aggregation`` drives it over an unreliable
fabric with the reference's seeded RNG stream, drop and fault injection, so
for the same seed the port and the reference give the same bits and the
same counters (tests/test_torch_switch.py).

Not ported yet: multi-tenancy (per-job quotas, the takeover lottery,
priority preemption: the ``switch_shared`` strategy), the jitted
``BatchedDataplane`` and the legacy per-packet switch (``core/switch.py``);
``run_aggregation`` refuses a switch without ``ingest_batch`` with
``NotPortedError``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import NotPortedError
from repro_torch import trace as _trace
from repro_torch.core import fpisa
from repro_torch.switchsim import COUNTERS, SLOT_STATE_FIELDS, npfpisa

_I_PACKETS, _I_DUP, _I_STALE, _I_OVERWRITE, _I_OVERFLOW, _I_RECLAIMED = range(6)


@dataclasses.dataclass(frozen=True)
class DataplaneConfig:
    """Static shape/semantics of a dataplane (frozen, hashable)."""

    num_workers: int
    num_slots: int = 8  # logical slots per pipeline (physical = 2x: double pool)
    elems_per_packet: int = 256
    fmt_name: str = "fp32"
    variant: str = "fpisa_a"  # fpisa_a | full
    num_pipelines: int = 1

    @property
    def fmt(self):
        return fpisa.FORMATS[self.fmt_name]

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


def slot_of(cfg: DataplaneConfig, chunks):
    """Global slot id for each chunk id (pipeline striping + double pool)."""
    pipe = chunks % cfg.num_pipelines
    slot = (chunks // cfg.num_pipelines) % cfg.physical_slots_per_pipeline
    return pipe * cfg.physical_slots_per_pipeline + slot


class NumpyDataplane:
    """The dataplane as a per-packet numpy loop over ``npfpisa`` primitives,
    with the reference's slot semantics and ``ingest_batch`` interface (the
    same bits and counters as the reference's numpy and jitted dataplanes;
    tests/test_torch_switch.py pins it). The ``switch_emu`` strategy runs on
    it. fp32 only."""

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
        self._live = np.ones((cfg.num_workers,), bool)
        self._counters = np.zeros((len(COUNTERS),), np.int64)
        self._recirc = [0] * cfg.num_pipelines
        # one `_`-prefixed attribute per shared slot-state field, so the
        # state layout cannot drift from the reference's silently
        missing = [f for f in SLOT_STATE_FIELDS
                   if not hasattr(self, f"_{f}")]
        assert not missing, f"NumpyDataplane missing mirror fields {missing}"

    @property
    def stats(self) -> dict:
        """Switch-wide counters (the tenancy counters stay 0) and the
        per-pipeline recirculations."""
        out = {name: int(self._counters[i]) for i, name in enumerate(COUNTERS)}
        out["recirculations"] = list(self._recirc)
        return out

    def reclaim_worker(self, worker: int):
        """Control-plane recovery: drop ``worker`` from the live set and reset
        its parked in-flight slots. Survivor retransmissions resubmit the
        reset chunks."""
        if not self._live[worker]:
            return
        self._live[worker] = False
        inflight = (self._slot_chunk >= 0) & ~self._result_valid
        self._exp[inflight] = 0
        self._man[inflight] = 0
        self._seen[inflight] = False
        self._counters[_I_RECLAIMED] += int(inflight.sum())

    def ingest_batch(self, workers, chunks, payloads):
        """Process packets (numpy in/out), one at a time in batch order.
        Returns (ready, results, accepted) aligned with the batch: ``ready``
        marks packets answered with a broadcast payload (slot completion or
        re-serve of a completed chunk), ``accepted`` those whose contribution
        was added."""
        cfg, F = self.cfg, npfpisa
        workers = np.asarray(workers, np.int64)
        chunks = np.asarray(chunks, np.int64)
        payloads = np.asarray(payloads, np.float32).reshape(
            len(workers), cfg.elems_per_packet)
        b = len(workers)
        add = F.fpisa_a_add if cfg.variant == "fpisa_a" else F.fpisa_add_full
        gids = slot_of(cfg, chunks)
        in_exp, in_man = F.encode(payloads)
        ready = np.zeros(b, bool)
        results = np.zeros((b, cfg.elems_per_packet), np.float32)
        accepted = np.zeros(b, bool)
        ct = self._counters
        for i in range(b):
            g, w, c = int(gids[i]), int(workers[i]), int(chunks[i])
            if not self._live[w] or self._slot_chunk[g] > c:
                ct[_I_STALE] += 1
                continue
            if self._slot_chunk[g] < c:  # claim: reset the slot for chunk c
                self._slot_chunk[g] = c
                self._seen[g] = False
                self._exp[g] = 0
                self._man[g] = 0
                self._result_valid[g] = False
            if self._seen[g, w]:
                ct[_I_DUP] += 1  # idempotent: do NOT re-add
                if self._result_valid[g]:
                    ready[i] = True
                    results[i] = self._result[g]
                continue
            self._seen[g, w] = True
            ct[_I_PACKETS] += 1
            e2, m2, over, ovf = add(self._exp[g], self._man[g], in_exp[i], in_man[i])
            self._exp[g], self._man[g] = e2, m2
            ct[_I_OVERWRITE] += int(over.sum())
            ct[_I_OVERFLOW] += int(ovf.sum())
            accepted[i] = True
            if cfg.variant == "full":
                self._recirc[g // cfg.physical_slots_per_pipeline] += 1
            if (self._seen[g] | ~self._live).all():
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
):
    """Batch-per-round all-reduce driver over an unreliable fabric.

    ``switch`` is a dataplane with ``ingest_batch`` (``NumpyDataplane``): one
    call per round with every eligible (worker, chunk) packet that survives
    the i.i.d. request drop. The seeded RNG is consumed as the reference
    consumes it (request drops drawn as one vector per round, per-worker
    result-delivery drops drawn per completion in packet order), so for
    identical seeds the port and the reference are **bit-identical** end to
    end, counters included. A per-packet switch without ``ingest_batch``
    (the reference's legacy ``core.switch.FpisaSwitch``) is not ported:
    ``NotPortedError``.

    Eligibility is snapshotted at round start: worker w may send chunk c iff
    it lacks c's result and holds the result of c - window (SwitchML's
    self-clocked streaming window, which makes slot recycling safe).

    Returns the aggregated (N,) vector; with ``record_arrivals`` also a
    {chunk: [workers in acceptance order]} dict for replaying the exact
    switch-arrival order through ``fpisa_sum_sequential``.

    Fault injection: with ``fail_worker``/``fail_round`` set, that worker
    crashes at the start of that round — it stops sending, and no result
    delivery is owed to it. ``detect_rounds`` rounds later the control plane's
    heartbeat timeout fires and ``switch.reclaim_worker`` frees its parked
    slots; the survivors' normal retransmissions (their shadow copies) then
    resubmit the reset chunks and the aggregation completes as a live-worker
    sum. Chunks whose slots completed before the death keep the dead worker's
    contribution (their cached results are re-served unchanged). The fault
    path consumes the shared RNG stream as the reference does, so runs stay
    bit-identical to it under injected failures.

    ``chunk_base`` offsets the on-wire chunk ids so one switch can carry many
    consecutive calls (e.g. one per training step) without its slot state
    going stale: chunk ids stay monotonic across calls, which is exactly the
    SwitchML recycling discipline. State carried over from the previous call
    is recycled naturally as the new chunks claim slots.
    """
    if not hasattr(switch, "ingest_batch"):
        raise NotPortedError("run_aggregation over a per-packet switch without "
                             "ingest_batch (core/switch.py)")
    cfg = switch.cfg
    w, n = worker_vectors.shape
    assert w == cfg.num_workers
    e = cfg.elems_per_packet
    pad = (-n) % e
    vecs = np.pad(worker_vectors, ((0, 0), (0, pad))).astype(np.float32)
    nchunks = vecs.shape[1] // e
    vecs3 = vecs.reshape(w, nchunks, e)
    rng = np.random.default_rng(seed)

    out = np.zeros((nchunks, e), np.float32)
    have_result = np.zeros((w, nchunks), bool)
    arrivals: dict[int, list[int]] = {}

    sp = _trace.span("switchsim.run_aggregation", phase="switch",
                     workers=w, nchunks=nchunks, drop_prob=drop_prob)
    with sp:
        rnd = _drive_rounds(
            switch, vecs3, out, have_result, arrivals, rng,
            drop_prob=drop_prob, max_rounds=max_rounds, window=cfg.window,
            record_arrivals=record_arrivals, fail_worker=fail_worker,
            fail_round=fail_round, detect_rounds=detect_rounds, chunk_base=chunk_base)
        if sp:
            sp.tag(rounds=rnd + 1)
    flat = out.reshape(-1)[:n]
    if record_arrivals:
        return flat, arrivals
    return flat


def _drive_rounds(switch, vecs3, out, have_result, arrivals, rng, *,
                  drop_prob, max_rounds, window, record_arrivals,
                  fail_worker, fail_round, detect_rounds, chunk_base):
    """The round-synchronous loop of ``run_aggregation`` (the reference's RNG
    stream, split out so run_aggregation's trace span wraps exactly the wire
    time). Returns the index of the last round."""
    nchunks = vecs3.shape[1]
    reclaim_at: int | None = None
    for rnd in range(max_rounds):
        if fail_round is not None and rnd == fail_round and fail_worker is not None:
            # the worker crashes: it stops sending and is owed no delivery
            have_result[fail_worker, :] = True
            reclaim_at = rnd + detect_rounds  # heartbeat timeout fires then
        if reclaim_at is not None and rnd >= reclaim_at:
            switch.reclaim_worker(fail_worker)
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
        ready, results, accepted = switch.ingest_batch(ws, cs + chunk_base, vecs3[ws, cs])
        if record_arrivals:
            for i in np.nonzero(accepted)[0]:
                arrivals.setdefault(int(cs[i]), []).append(int(ws[i]))
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
