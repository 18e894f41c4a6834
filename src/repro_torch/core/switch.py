"""Per-packet PISA switch emulator: the compatibility view over the batched
dataplane (port of ``repro.core.switch``).

The protocol semantics (slot pool, worker bitmap idempotence, SwitchML
double-pool window recycling, exactly-once aggregation under an unreliable
fabric) live once, in ``repro_torch/switchsim/dataplane.py``.
``FpisaSwitch`` keeps the one-packet-at-a-time API by driving a
single-pipeline ``BatchedDataplane`` with batch size 1; ``run_aggregation``
keeps the legacy *immediate-eligibility* driver loop (a worker's send can
unblock a later worker within the same round).

Use ``repro_torch.switchsim`` directly for anything throughput-sensitive:
its ``run_aggregation`` submits every eligible packet of a round as one
batch and models multiple ingress pipelines.

Stats note: retransmissions that arrive after their slot was recycled for a
newer chunk are counted under ``stats["stale"]``; ``stats["duplicates"]``
counts only true bitmap hits (same (worker, chunk) seen twice).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import switchsim
from repro_torch.core import fpisa


@dataclasses.dataclass
class SwitchConfig:
    num_workers: int
    num_slots: int = 8
    elems_per_packet: int = 256  # paper: largest SwitchML packet
    fmt_name: str = "fp32"
    variant: str = "fpisa_a"  # fpisa_a | full

    @property
    def fmt(self):
        return fpisa.FORMATS[self.fmt_name]


@dataclasses.dataclass
class Packet:
    worker: int
    chunk: int
    payload: np.ndarray  # float32 (elems_per_packet,)


@dataclasses.dataclass
class ResultPacket:
    chunk: int
    payload: np.ndarray


class FpisaSwitch:
    """One emulated ingress pipeline worth of FPISA aggregation slots
    (per-packet view over a 1-pipeline batched dataplane on ``device``: the
    card unless the caller passes the CPU)."""

    def __init__(self, cfg: SwitchConfig, device=None):
        self.cfg = cfg
        self._dp = switchsim.BatchedDataplane(switchsim.DataplaneConfig(
            num_workers=cfg.num_workers,
            num_slots=cfg.num_slots,
            elems_per_packet=cfg.elems_per_packet,
            fmt_name=cfg.fmt_name,
            variant=cfg.variant,
            num_pipelines=1,
            rounds_per_call=1,  # one packet per call: rank is always 0
        ), device=device)
        self.num_physical_slots = self._dp.cfg.physical_slots_per_pipeline

    @property
    def stats(self) -> dict:
        s = self._dp.stats
        return {k: s[k] for k in switchsim.COUNTERS}

    @property
    def job_stats(self) -> list:
        """Per-tenant counters of the underlying dataplane."""
        return self._dp.job_stats

    def reclaim_worker(self, worker: int, job: int = 0):
        """Dead-worker reclamation (control plane): free the worker's parked
        in-flight slots owned by ``job`` and waive its bitmap bit for future
        completions (switchsim/dataplane.py)."""
        self._dp.reclaim_worker(worker, job)

    def ingest(self, pkt: Packet, job: int = 0, now: int = 0) -> ResultPacket | None:
        """Process one packet; returns the broadcast result when a slot fills,
        or re-serves the cached result for duplicate packets of a completed
        chunk (idempotent exactly-once aggregation under retransmission).
        ``job``/``now`` tag the packet's tenant and the driver's staleness
        clock on a multi-tenant switch."""
        ready, results, _ = self._dp.ingest_batch(
            [pkt.worker], [pkt.chunk], pkt.payload[None, :],
            jobs=[job], now=now)
        if ready[0]:
            return ResultPacket(chunk=pkt.chunk, payload=results[0])
        return None


def run_aggregation(
    switch: FpisaSwitch,
    worker_vectors: np.ndarray,
    drop_prob: float = 0.0,
    seed: int = 0,
    max_rounds: int = 10_000,
) -> np.ndarray:
    """Drive a full all-reduce of ``worker_vectors`` (W, N) through the switch.

    Simulates an unreliable fabric in BOTH directions: each request and each
    per-worker result delivery is dropped i.i.d. with ``drop_prob``; workers
    retransmit un-acked chunks each round (timeout) and the switch re-serves
    completed slots idempotently. A worker may only send chunk ``c`` after it
    has received the result of chunk ``c - num_slots`` (SwitchML's
    self-clocked streaming window). Returns the aggregated (N,) vector.

    This is the legacy immediate-eligibility schedule (eligibility re-checked
    per packet, so completions unblock later sends within the same round).
    ``repro_torch.switchsim.run_aggregation`` is the batched round-synchronous
    driver; it accepts this class too, for per-packet/batched parity runs.
    """
    cfg = switch.cfg
    w, n = worker_vectors.shape
    assert w == cfg.num_workers
    e = cfg.elems_per_packet
    pad = (-n) % e
    vecs = np.pad(worker_vectors, ((0, 0), (0, pad))).astype(np.float32)
    nchunks = vecs.shape[1] // e
    rng = np.random.default_rng(seed)

    out = np.zeros_like(vecs[0])
    have_result = np.zeros((w, nchunks), bool)  # per-worker result delivery

    def eligible(worker: int, c: int) -> bool:
        if c >= nchunks or have_result[worker, c]:
            return False
        prev = c - cfg.num_slots
        return prev < 0 or have_result[worker, prev]

    for _ in range(max_rounds):
        if have_result.all():
            break
        for worker in range(w):
            for c in range(nchunks):
                if not eligible(worker, c):
                    continue
                if rng.random() < drop_prob:
                    continue  # request lost; retried next round
                res = switch.ingest(Packet(worker, c, vecs[worker, c * e:(c + 1) * e]))
                if res is not None:
                    out[c * e:(c + 1) * e] = res.payload
                    # broadcast: each worker's copy may be dropped independently
                    for wk in range(w):
                        if not have_result[wk, c] and rng.random() >= drop_prob:
                            have_result[wk, c] = True
    if not have_result.all():
        raise RuntimeError("aggregation did not complete within max_rounds")
    return out[:n]
