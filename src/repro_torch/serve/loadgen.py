"""Poisson load generator + SLO percentile reporting for the serving path
(a copy of ``repro.serve.loadgen``: the same seed gives the same trace).

Models the ROADMAP's "millions of users" traffic shape at benchmark scale:
request arrivals are a Poisson process (exponential inter-arrival times at
``rate`` requests per scheduler step), prompt lengths are drawn from a
discrete mixed distribution (short chat turns + long documents), and decode
budgets from a separate mixed distribution — the regime where static
batching wastes the most work (a lockstep batch runs to its longest slot)
and dense KV allocation pins the most idle memory.

Prompt lengths are drawn from a DISCRETE set on purpose: the continuous
engine prefills unpadded and packs only identical lengths together, so a
small length alphabet keeps the jit cache small while still exercising
mixed-length traffic. Times are in scheduler-step units (1 = one decode
iteration), matching ``ContinuousEngine.run_trace``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.engine import Request

__all__ = ["PoissonLoadGen", "percentile", "latency_report"]


@dataclasses.dataclass
class PoissonLoadGen:
    """Poisson arrivals with mixed prompt/decode length distributions.

    rate: mean arrivals per scheduler step (lambda).
    prompt_lens / prompt_weights: discrete prompt-length distribution.
    max_new / max_new_weights: discrete decode-budget distribution.
    """
    rate: float = 0.5
    prompt_lens: Sequence[int] = (8, 16, 32)
    prompt_weights: Optional[Sequence[float]] = None
    max_new: Sequence[int] = (4, 8, 16, 32, 64)
    max_new_weights: Optional[Sequence[float]] = None
    vocab_size: int = 256
    seed: int = 0

    def trace(self, n: int,
              rng: Optional[np.random.Generator] = None,
              ) -> List[Tuple[float, Request]]:
        """Generate ``n`` arrivals as (t_arrival, Request), time-sorted.

        Every stochastic draw comes from ONE explicitly seeded
        ``np.random.Generator`` — pass ``rng`` to thread a caller-owned
        stream (e.g. one Generator shared by a whole benchmark run); by
        default a fresh ``default_rng(self.seed)`` makes repeated ``trace``
        calls identical."""
        if rng is None:
            rng = np.random.default_rng(self.seed)
        pw = self._norm(self.prompt_weights, len(self.prompt_lens))
        nw = self._norm(self.max_new_weights, len(self.max_new))
        t = 0.0
        out: List[Tuple[float, Request]] = []
        for rid in range(n):
            t += float(rng.exponential(1.0 / self.rate))
            plen = int(rng.choice(np.asarray(self.prompt_lens), p=pw))
            budget = int(rng.choice(np.asarray(self.max_new), p=nw))
            prompt = rng.integers(0, self.vocab_size, plen).astype(np.int32)
            out.append((t, Request(rid=rid, prompt=prompt,
                                   max_new_tokens=budget)))
        return out

    @staticmethod
    def _norm(w, n):
        if w is None:
            return np.full(n, 1.0 / n)
        w = np.asarray(w, np.float64)
        return w / w.sum()


def percentile(xs: Sequence[float], p: float) -> float:
    """Percentile over finite values (nan-safe); nan when empty."""
    vals = [x for x in xs if not math.isnan(x)]
    if not vals:
        return math.nan
    return float(np.percentile(np.asarray(vals, np.float64), p))


def latency_report(stats, slo_ttft: Optional[float] = None,
                   slo_tpot: Optional[float] = None) -> Dict[str, float]:
    """p50/p99 TTFT + TPOT (scheduler-step units) over finished requests,
    plus SLO attainment fractions when targets are given."""
    ttfts = [s.ttft for s in stats]
    tpots = [s.tpot for s in stats]
    rep = {
        "n": float(len(stats)),
        "ttft_p50": percentile(ttfts, 50), "ttft_p99": percentile(ttfts, 99),
        "tpot_p50": percentile(tpots, 50), "tpot_p99": percentile(tpots, 99),
    }
    if slo_ttft is not None:
        ok = [t for t in ttfts if not math.isnan(t) and t <= slo_ttft]
        rep["ttft_slo_attainment"] = len(ok) / max(len(stats), 1)
    if slo_tpot is not None:
        fin = [t for t in tpots if not math.isnan(t)]
        ok = [t for t in fin if t <= slo_tpot]
        rep["tpot_slo_attainment"] = len(ok) / max(len(fin), 1)
    return rep
