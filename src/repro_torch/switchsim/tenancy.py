"""Multi-tenant driving of one shared switch dataplane (port of
``repro.switchsim.tenancy``).

``dataplane.py`` implements the per-packet tenancy *rules* (quota regions,
weighted takeover lottery, priority preemption, per-job counters); this
module supplies the pieces that live above the switch:

* :func:`run_multitenant` — the shared-fabric driver: J jobs (each its own
  worker set, vector stream and streaming window) retransmit into ONE
  dataplane round-synchronously, as ``run_aggregation`` does for one job.
  Packets are submitted job-major within a round, so with ``num_jobs=1``
  the driver consumes the seeded RNG identically to ``run_aggregation`` and
  the runs are bit-identical.

  Master-backed re-serve: a cross-tenant takeover can recycle a stale
  completed slot while a victim worker still lacks its result, so the
  driver keeps the master's copy of every completed chunk and re-serves it
  (with the usual per-worker delivery drop draw) whenever a retransmission
  of a completed chunk comes back unanswered — the ATP-style
  parameter-server fallback. It can never fire with one tenant or with
  disjoint quota partitions, so it consumes no RNG in the parity cases.

* :func:`jain_fairness` — Jain's index over per-job goodput (1.0 = fair).

* the **shared-dataplane registry** — named process-global
  ``NumpyDataplane`` instances, so several ``switch_emu`` aggregators (one
  per training job or server) plus query streams contend for the same
  emulated switch. The registry keeps per-job monotone chunk bases
  (SwitchML recycling discipline across calls) and a monotone staleness
  clock so one call's leftover slots age out before the next tenant's
  traffic arrives. It is guarded by one lock, as several threads of one
  process may aggregate at once.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np

from repro_torch import trace as _trace
from repro_torch.switchsim.dataplane import (
    DataplaneConfig,
    NumpyDataplane,
    run_aggregation,
)

__all__ = [
    "jain_fairness",
    "run_multitenant",
    "reset_shared_dataplanes",
    "shared_dataplane",
    "shared_emulated_allreduce",
]


def jain_fairness(xs) -> float:
    """Jain's fairness index (sum x)^2 / (n * sum x^2) over per-job rates:
    1.0 when every job gets an equal share, 1/n when one job starves all
    others."""
    xs = np.asarray(xs, np.float64)
    denom = len(xs) * float((xs * xs).sum())
    return float(xs.sum()) ** 2 / denom if denom else 0.0


def run_multitenant(
    switch,
    job_vectors,
    drop_prob: float = 0.0,
    seed: int = 0,
    max_rounds: int = 10_000,
    chunk_base: int = 0,
    now_base: int = 0,
):
    """All-reduce each job's (W_j, N_j) vectors through ONE shared switch.

    ``switch`` is a Batched/Numpy dataplane whose config declares
    ``num_jobs == len(job_vectors)`` tenants; ``job_vectors[j]`` must have
    ``cfg.ports[j]`` rows. Every round, each unfinished job contributes its
    eligible packets (per-job self-clocked window over its own quota) and
    the concatenated job-major batch goes through one ingest; completions
    and master-backed re-serves (module doc) deliver results per worker
    under the same i.i.d. drop model as ``run_aggregation``.

    Returns ``(flats, report)``: the per-job aggregated (N_j,) vectors and a
    report dict with ``rounds`` (total rounds driven), ``done_round`` (first
    round after which each job held all results — its completion time), and
    the switch's ``job_stats``.
    """
    cfg = switch.cfg
    jn = cfg.num_jobs
    assert len(job_vectors) == jn, (len(job_vectors), jn)
    e = cfg.elems_per_packet
    vecs3, out, have, got, nlens = [], [], [], [], []
    for j, v in enumerate(job_vectors):
        v = np.asarray(v)
        w, n = v.shape
        assert w == cfg.ports[j], f"job {j}: {w} rows != port count {cfg.ports[j]}"
        pad = (-n) % e
        vp = np.pad(v, ((0, 0), (0, pad))).astype(np.float32)
        nc = vp.shape[1] // e
        vecs3.append(vp.reshape(w, nc, e))
        out.append(np.zeros((nc, e), np.float32))
        have.append(np.zeros((w, nc), bool))
        got.append(np.zeros(nc, bool))
        nlens.append(n)
    rng = np.random.default_rng(seed)
    done_round: list[int | None] = [None] * jn

    sp = _trace.span("switchsim.run_multitenant", phase="switch",
                     num_jobs=jn, drop_prob=drop_prob)
    with sp:
        rnd = _drive_tenant_rounds(
            switch, cfg, vecs3, out, have, got, done_round, rng,
            drop_prob=drop_prob, max_rounds=max_rounds,
            chunk_base=chunk_base, now_base=now_base)
        if sp:
            sp.tag(rounds=rnd)
    switch.last_now = now_base + rnd
    flats = [out[j].reshape(-1)[: nlens[j]] for j in range(jn)]
    report = {
        "rounds": rnd,
        "done_round": done_round,
        "job_stats": getattr(switch, "job_stats", None),
    }
    return flats, report


def _drive_tenant_rounds(switch, cfg, vecs3, out, have, got, done_round, rng,
                         *, drop_prob, max_rounds, chunk_base, now_base):
    """The round loop of ``run_multitenant`` (identical RNG stream; split
    out so the driver's trace span wraps exactly the shared-fabric time)."""
    jn = cfg.num_jobs
    rnd = 0
    for rnd in range(max_rounds):
        if all(h.all() for h in have):
            break
        parts = []
        for j in range(jn):
            if have[j].all():
                continue
            window = cfg.job_window(j)
            elig = ~have[j]
            if elig.shape[1] > window:
                elig[:, window:] &= have[j][:, :-window]
            ws, cs = np.nonzero(elig)  # row-major: worker-major packet order
            keep = rng.random(ws.size) >= drop_prob
            ws, cs = ws[keep], cs[keep]
            if ws.size:
                parts.append((np.full(ws.size, j, np.int32), ws, cs,
                              vecs3[j][ws, cs]))
        if not parts:
            continue
        jbs = np.concatenate([p[0] for p in parts])
        ws = np.concatenate([p[1] for p in parts])
        cs = np.concatenate([p[2] for p in parts])
        payloads = np.concatenate([p[3] for p in parts])
        ready, results, accepted = switch.ingest_batch(
            ws, cs + chunk_base, payloads, jobs=jbs, now=now_base + rnd)
        got_pre = [g.copy() for g in got]  # chunks completed BEFORE this round
        for i in np.nonzero(ready)[0]:
            j, c = int(jbs[i]), int(cs[i])
            out[j][c] = results[i]
            got[j][c] = True
            miss = np.nonzero(~have[j][:, c])[0]
            if miss.size:
                ok = rng.random(miss.size) >= drop_prob
                have[j][miss[ok], c] = True
        # master-backed re-serve (module doc): unanswered retransmissions of
        # chunks the master completed in an EARLIER round. A packet the
        # switch neither answered (ready) nor absorbed (accepted) for such a
        # chunk can only mean the slot was recycled out from under the victim
        # by a cross-tenant takeover, so this consumes no RNG in the parity
        # cases. (Same-round completions are excluded: their delivery draw
        # above already covered every missing worker, dup senders included.)
        for i in np.nonzero(~np.asarray(ready) & ~np.asarray(accepted))[0]:
            j, c = int(jbs[i]), int(cs[i])
            if got_pre[j][c]:
                miss = np.nonzero(~have[j][:, c])[0]
                if miss.size:
                    ok = rng.random(miss.size) >= drop_prob
                    have[j][miss[ok], c] = True
        for j in range(jn):
            if done_round[j] is None and have[j].all():
                done_round[j] = rnd + 1
    if not all(h.all() for h in have):
        raise RuntimeError("multi-tenant aggregation did not complete "
                           "within max_rounds")
    return rnd


# ---------------------------------------------------------------------------
# shared emulated switches (switch_emu tenancy wiring)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _SharedSwitch:
    dp: NumpyDataplane
    chunk_base: list  # per-job monotone chunk offset (SwitchML recycling)
    clock: int  # staleness clock handed to the next call as now_base


_SHARED: dict[str, _SharedSwitch] = {}
_SHARED_LOCK = threading.Lock()


def reset_shared_dataplanes():
    """Drop every named shared dataplane (tests / fresh experiments)."""
    with _SHARED_LOCK:
        _SHARED.clear()


def shared_dataplane(name: str, cfg: DataplaneConfig) -> NumpyDataplane:
    """Get or create the named process-global numpy dataplane. Subsequent
    callers must agree on the config — a mismatch is a wiring bug and fails
    loudly rather than silently aggregating across different topologies."""
    with _SHARED_LOCK:
        entry = _SHARED.get(name)
        if entry is None:
            entry = _SharedSwitch(NumpyDataplane(cfg), [0] * cfg.num_jobs, 0)
            _SHARED[name] = entry
        elif entry.dp.cfg != cfg:
            raise ValueError(
                f"shared dataplane {name!r} already exists with config "
                f"{entry.dp.cfg}; refusing mismatched config {cfg}")
        return entry.dp


def shared_emulated_allreduce(
    name: str,
    vals: np.ndarray,
    *,
    num_jobs: int,
    job: int,
    num_slots: int = 8,
    elems_per_packet: int = 256,
) -> np.ndarray:
    """Aggregate (W, N) ``vals`` as tenant ``job`` of the named shared switch
    (host-side: called from the ``switch_emu`` strategy).

    Every tenant drives the same ``NumpyDataplane`` with a fully shared slot
    pool; per-job chunk bases stay monotone across calls and the staleness
    clock advances past ``stale_after`` between calls, so one tenant's
    leftover completed slots are lottery-claimable by the next.
    """
    vals = np.asarray(vals, np.float32)
    w = vals.shape[0]
    cfg = DataplaneConfig(
        num_workers=w, num_slots=num_slots, elems_per_packet=elems_per_packet,
        fmt_name="fp32", variant="fpisa_a", num_jobs=num_jobs,
        job_workers=(w,) * num_jobs)
    shared_dataplane(name, cfg)  # create-or-validate
    with _SHARED_LOCK:
        entry = _SHARED[name]
        nchunks = -(-vals.shape[1] // elems_per_packet)
        out = run_aggregation(
            entry.dp, vals, job=job,
            chunk_base=entry.chunk_base[job], now_base=entry.clock)
        entry.chunk_base[job] += nchunks
        # advance past stale_after: the call's windows age out before the
        # next tenant's traffic arrives
        entry.clock = entry.dp.last_now + cfg.stale_after + 1
        return out.astype(np.float32)
