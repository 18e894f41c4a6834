"""Replay-based cost model over recorded phase spans (torch port of
``repro.autotune.costmodel``, pure Python and numpy).

The bucketer's double-buffered pipeline issues, per bucket,
``encode -> collective -> finish`` with the finish of bucket *i-1* and the
encode of bucket *i+1* overlapping the collective of bucket *i*. Each phase's
cost is modeled as affine in the bucket's element count::

    t_phase(n) = a_phase + b_phase * n          (seconds)

fitted by least squares over the ``synced`` spans of a recorded trace (the
spans the tracer actually blocked on — trace-time artifacts from inside a
jit are marked ``synced=False`` and excluded). The fixed cost ``a`` is the
per-dispatch overhead the paper's streaming design amortizes; ``b`` is the
per-element transform/wire cost.

A whole bucket plan is scored with the pipeline recurrence
:meth:`CostModel.pipeline_time`: the collective of bucket *i* hides
``encode(i+1) + finish(i-1)`` (or vice versa — whichever is longer bounds
the stage), which is exactly why an interior bucket size can win: one giant
bucket has no overlap to hide its encode/finish, many tiny buckets pay the
fixed cost ``a`` once per bucket.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Sequence

import numpy as np

PHASES = ("encode", "collective", "finish")


@dataclasses.dataclass(frozen=True)
class PhaseCost:
    a: float  # fixed per-dispatch seconds
    b: float  # per-element seconds

    def __call__(self, elems: int) -> float:
        return self.a + self.b * elems


@dataclasses.dataclass(frozen=True)
class CostModel:
    phases: Mapping[str, PhaseCost]
    samples: Mapping[str, int] = dataclasses.field(default_factory=dict)

    def phase_time(self, phase: str, elems: int) -> float:
        return self.phases[phase](elems)

    def pipeline_time(self, sizes: Sequence[int]) -> float:
        """Predicted wall time of one double-buffered pass over buckets of
        ``sizes`` elements (dispatch order). Stage *i* is bounded by the
        longer of its collective and the overlapped transform work
        ``encode(i+1) + finish(i-1)``; the first encode and last finish
        cannot be hidden."""
        if not sizes:
            return 0.0
        enc = [self.phase_time("encode", n) for n in sizes]
        col = [self.phase_time("collective", n) for n in sizes]
        fin = [self.phase_time("finish", n) for n in sizes]
        k = len(sizes)
        total = enc[0]
        for i in range(k):
            hidden = (enc[i + 1] if i + 1 < k else 0.0) \
                + (fin[i - 1] if i > 0 else 0.0)
            total += max(col[i], hidden)
        total += fin[k - 1]
        return total

    def to_dict(self) -> dict:
        return {
            "phases": {p: {"a": c.a, "b": c.b}
                       for p, c in self.phases.items()},
            "samples": dict(self.samples),
        }


def _phase_samples(spans: Iterable[dict]) -> dict[str, list[tuple[int, float]]]:
    by_phase: dict[str, list[tuple[int, float]]] = {p: [] for p in PHASES}
    for sp in spans:
        tags = sp.get("tags", {})
        phase = tags.get("phase")
        elems = tags.get("elems")
        if phase in by_phase and elems is not None and sp.get("synced"):
            by_phase[phase].append((int(elems), float(sp["dur"])))
    return by_phase


def fit(spans: Iterable[dict]) -> CostModel:
    """Least-squares affine fit per phase from recorded span dicts.

    Requires, per phase, synced samples at >= 2 distinct bucket sizes (a
    single size cannot separate fixed from per-element cost); fails loudly
    otherwise — a cost model silently fitted from nothing would 'tune' the
    bucket plan from noise."""
    by_phase = _phase_samples(spans)
    phases: dict[str, PhaseCost] = {}
    samples: dict[str, int] = {}
    for phase, pts in by_phase.items():
        sizes = {n for n, _ in pts}
        if len(sizes) < 2:
            raise ValueError(
                f"cost model needs synced '{phase}' spans at >= 2 distinct "
                f"bucket sizes, got {len(sizes)} "
                f"({len(pts)} samples); record a trace with "
                f"repro_torch.autotune.profile_phases or --trace-out on a "
                f"bucketed run")
        xs = np.array([n for n, _ in pts], np.float64)
        ys = np.array([t for _, t in pts], np.float64)
        b, a = np.polyfit(xs, ys, 1)
        # noise can drive an intercept/slope slightly negative; costs are not
        phases[phase] = PhaseCost(a=max(float(a), 0.0), b=max(float(b), 0.0))
        samples[phase] = len(pts)
    return CostModel(phases=phases, samples=samples)


def fit_from_jsonl(path) -> CostModel:
    """Fit from a trace file written by the tracer's JSONL export (schema
    checked by ``repro_torch.trace.read_jsonl``)."""
    from repro_torch.trace import read_jsonl

    _, spans = read_jsonl(path)
    return fit(spans)
