"""Distributed query processing with in-switch FPISA operators (paper Sec. 6;
port of ``repro.db.query``).

Reproduces the Cheetah [SIGMOD'20] / NETACCEL [CIDR'19] acceleration patterns
with FP32 data, which the original systems cannot handle:

* in-switch PRUNING (Top-N): the switch keeps a running threshold register
  in FPISA planes and drops rows that cannot affect the final result; only
  survivors reach the master. FP comparison is FPISA subtraction + sign test
  (Sec. 2.2) — integer-only.
* in-switch AGGREGATION (group-by sum): per-group FPISA accumulator slots
  (full FPISA add — query aggregation needs the RSAW hardware extension
  rather than the FPISA-A approximation, Sec. 6.1).

The "workers -> switch -> master" dataflow is emulated: workers stream row
batches, the switch side runs as the operators of
``repro_torch/switchsim/query.py`` on a device (the card unless the caller
passes the CPU; without a card the operators raise), and the master does
the final exact processing on the survivors. A column given as numpy is
uploaded once; a column may already sit on the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import fpisa
from repro_torch.switchsim import query as swq


def _cmp_planes(a: fpisa.Planes, b: fpisa.Planes) -> torch.Tensor:
    """FPISA comparison a > b via subtraction sign (integer-only)."""
    neg_b = fpisa.Planes(exp=b.exp, man=-b.man)
    diff, _ = fpisa.fpisa_add_full(a, neg_b)
    return diff.man > 0


def _column(x, dtype, device) -> torch.Tensor:
    """A column on ``device``: a tensor is moved there, numpy is uploaded."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device, dtype=dtype)


@dataclasses.dataclass
class SwitchStats:
    rows_in: int = 0
    rows_out: int = 0

    @property
    def prune_rate(self) -> float:
        return 1.0 - self.rows_out / max(self.rows_in, 1)


class TopNPruner:
    """In-switch Top-N on an FP32 column. The switch keeps the N-th best value
    seen so far in FPISA registers; rows below it are dropped (Cheetah's
    pruning abstraction) — one ``switchsim.query.topn_keep`` per row batch.
    The master exactly sorts the survivors."""

    def __init__(self, n: int, device=None):
        self.n = n
        self.device = resolve_device(device)
        self.stats = SwitchStats()

    def run(self, values, batch: int = 256) -> np.ndarray:
        """values: worker-streamed FP32 column. Returns indices of survivors
        (int64, on the host). The threshold planes and the switch-side heap
        stay on the device; each batch brings back only its survivor
        indices."""
        values = _column(values, torch.float32, self.device)
        thresh = None  # FPISA planes of the current N-th best
        heap = values[:0]  # switch-side shadow of the N best
        survivors = []
        for lo in range(0, values.shape[0], batch):
            chunk = values[lo:lo + batch]
            self.stats.rows_in += chunk.shape[0]
            if thresh is None:
                idx = torch.arange(chunk.shape[0], device=self.device)
            else:
                idx = torch.nonzero(swq.topn_keep(chunk, *thresh)).squeeze(1)
            survivors.append(idx + lo)
            self.stats.rows_out += idx.shape[0]
            heap = torch.cat([heap, chunk[idx]])
            if heap.shape[0] >= self.n:
                heap = torch.topk(heap, self.n).values
                t = fpisa.encode(heap.min())
                thresh = (t.exp, t.man)
        return torch.cat(survivors).cpu().numpy().astype(np.int64)


class GroupBySum:
    """In-switch hash aggregation: value column summed per group key in FPISA
    accumulator slots (full-FPISA add). Only per-group aggregates leave the
    switch — the row stream itself is consumed in-network.

    Rows are streamed through ``switchsim.query.groupby_ingest`` in batches
    sorted by key (stable, preserving packet order within a key), applied
    with per-slot sequential semantics. The slot planes ``exp``, ``man`` and
    ``since`` live on the device across batches and calls."""

    # The paper's headroom analysis (Sec. 3.3): 7 headroom bits cover ~128
    # same-scale adds before the int32 register can overflow. Long-running
    # group-by slots therefore FLUSH periodically: renormalize + re-encode the
    # register (in deployment: emit a partial aggregate to the master and
    # reset the slot). 64 keeps a 2x safety margin. The flush counter lives in
    # the slot and persists across batches.
    FLUSH_EVERY = 64

    def __init__(self, num_slots: int, variant: str = "full", device=None):
        self.num_slots = num_slots
        self.variant = variant
        self.device = resolve_device(device)
        zeros = torch.zeros(num_slots, dtype=torch.int32, device=self.device)
        self.exp, self.man, self.since = zeros, zeros.clone(), zeros.clone()
        self.stats = SwitchStats()

    def run(self, keys, values, batch: int = 65536) -> dict:
        keys = _column(keys, torch.int64, self.device)
        values = _column(values, torch.float32, self.device)
        if int(keys.max()) >= self.num_slots:
            raise ValueError("hash table sized for distinct keys: a key is >= num_slots")
        self.stats.rows_in += keys.shape[0]
        exp, man, since = self.exp, self.man, self.since
        deferred = torch.zeros((), dtype=torch.bool, device=self.device)
        for lo in range(0, keys.shape[0], batch):
            order = torch.argsort(keys[lo:lo + batch], stable=True)
            k, v = keys[lo:lo + batch][order], values[lo:lo + batch][order]
            # rounds = the batch's largest per-key multiplicity, exactly: the
            # reference's power-of-two cover only bounds jit recompiles, and
            # the extra columns it scans are empty (no add, no flush due)
            rounds = int(torch.bincount(k, minlength=self.num_slots).max())
            exp, man, since, dfr = swq.groupby_ingest(
                exp, man, since, k, v, torch.ones_like(k, dtype=torch.bool),
                num_slots=self.num_slots, rounds=rounds, variant=self.variant,
                flush_every=self.FLUSH_EVERY)
            deferred = deferred | dfr.any()
        assert not bool(deferred)
        self.exp, self.man, self.since = exp, man, since
        present = torch.unique(keys).tolist()
        self.stats.rows_out += len(present)
        out = fpisa.renormalize(fpisa.Planes(self.exp, self.man)).tolist()
        return {int(k): float(out[k]) for k in present}


class StreamedGroupBySum:
    """Group-by sum riding a (possibly multi-tenant) switch *dataplane* as a
    query stream: each row batch collapses worker-side into one packet
    carrying the batch's per-group partial sums, the packets contend for
    aggregation slots like any other tenant's traffic (a single-port job:
    one chunk per row batch), and the master folds the delivered partials
    into totals. Drive :meth:`vectors` through
    ``switchsim.tenancy.run_multitenant`` as one of its jobs and hand the
    returned flat vector to :meth:`finalize`.

    The partial sums are the worker's side of the wire and are computed on
    the host in float64 in row order, as the reference computes them (a
    column on the device is brought back once); the switch side is the
    dataplane, on the card when ``run_multitenant`` drives a
    ``BatchedDataplane`` there.

    Accuracy note: the switch round-trips each partial through FPISA
    encode/decode (a W=1 slot completes on its single packet), so totals
    carry one quantization per batch.
    """

    def __init__(self, num_groups: int, elems_per_packet: int = 256):
        assert num_groups <= elems_per_packet, \
            "per-batch partials must fit one packet"
        self.num_groups = num_groups
        self.elems_per_packet = elems_per_packet
        self.stats = SwitchStats()

    def vectors(self, keys, values, batch: int = 4096) -> np.ndarray:
        """(1, nbatches * elems_per_packet) worker vector: row batch b's
        per-group partial sums occupy chunk b's first ``num_groups`` lanes."""
        keys = _column(keys, torch.int64, "cpu").numpy()
        values = _column(values, torch.float32, "cpu").numpy()
        assert keys.max() < self.num_groups, "hash table sized for distinct keys"
        self.stats.rows_in += len(keys)
        parts = []
        for lo in range(0, len(keys), batch):
            part = np.bincount(
                keys[lo:lo + batch],
                weights=values[lo:lo + batch].astype(np.float64),
                minlength=self.num_groups).astype(np.float32)
            parts.append(np.pad(part, (0, self.elems_per_packet - self.num_groups)))
        self.stats.rows_out += len(parts)  # one partial packet per batch
        return np.concatenate(parts)[None, :]

    def finalize(self, flat: np.ndarray) -> dict:
        """Fold the aggregated flat vector (as returned for this job by
        ``run_multitenant``) back into {group: total}."""
        part = np.asarray(flat).reshape(-1, self.elems_per_packet)
        totals = part[:, : self.num_groups].astype(np.float64).sum(axis=0)
        return {int(k): float(totals[k]) for k in range(self.num_groups)}


def spark_like_topn(values: np.ndarray, n: int) -> np.ndarray:
    """Full-scan baseline on the host: every row is shipped to the master
    and sorted."""
    return np.sort(values)[::-1][:n]


def spark_like_groupby(keys: np.ndarray, values: np.ndarray) -> dict:
    """Full-scan baseline on the host: an exact float64 sum per group."""
    out = {}
    for k in np.unique(keys):
        out[int(k)] = float(values[keys == k].astype(np.float64).sum())
    return out
