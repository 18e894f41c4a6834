"""Aggregation cells: the program's stacked FPISA aggregation
(``Aggregator(AggConfig(...), stacked=True).allreduce_tree``) of W logical
workers' gradient trees, one call after another, as a trainer queues one
a step.

Set-up makes ``inputs`` distinct trees on the card from the seed: for each,
every leaf of the configuration's gradient tree as a (W, ...) stack in the
leaf's dtype, each worker's leaf drawn from a normal scaled by 10^u, u
uniform in ``log10_scale`` per leaf and worker. The window cycles through
the trees. A sample of the calls, drawn from the seed, keeps its output,
and so does the last; after the window each is compared, bit for bit, with
the plain FPISA sum (``fpisa_ref``) of the same tree.

Traffic keys: ``workers``, ``inputs``, ``dtype``, ``log10_scale``, ``agg``
(``AggConfig`` fields), ``warmup_calls``, ``sample_calls`` (how many, and
from how many first calls), ``profile_calls``, ``host_profile_calls``.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from fpisa_bench import common, fpisa_ref, spec

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def make_trees(pspec: list, traffic: dict, seed: int, device) -> list:
    """``inputs`` trees {leaf: (W, ...) stack}; each tree one normal draw
    over all its leaves, then each worker's leaf scaled."""
    w, dtype = traffic["workers"], DTYPES[traffic["dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    lo, hi = traffic["log10_scale"]
    sizes = [w * math.prod(shape) for _, shape, _ in pspec]
    trees = []
    for _ in range(traffic["inputs"]):
        flat = torch.empty(sum(sizes), dtype=dtype, device=device).normal_(generator=gen)
        tree = {}
        for (name, shape, _), part in zip(pspec, flat.split(sizes)):
            scale = torch.tensor(10.0 ** rng.uniform(lo, hi, size=w), dtype=torch.float32)
            leaf = part.view(w, *shape)
            leaf.mul_(scale.to(device=device, dtype=dtype).view(w, *[1] * len(shape)))
            tree[name] = leaf
        trees.append(tree)
    return trees


BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def mismatches(outs: list, tree: dict) -> list:
    """For each output tree in ``outs``, the elements whose bits differ
    from the plain FPISA sum of ``tree`` in the leaf's dtype (a missing or
    misshapen leaf counts whole)."""
    bad = [0] * len(outs)
    for name, stack in tree.items():
        want = fpisa_ref.aggregate(stack).to(stack.dtype)
        bits = BITS[want.element_size()]
        for j, out in enumerate(outs):
            got = out.get(name)
            if got is None or got.shape != want.shape or got.dtype != want.dtype:
                bad[j] += want.numel()
            else:
                bad[j] += int((got.contiguous().view(bits) != want.view(bits)).sum())
    return bad


def run(r: common.Run, limits: dict) -> None:
    from repro_torch.core.agg import AggConfig, Aggregator

    tr, dev = r.cell.traffic, r.device
    pspec = spec.reference(r.cell.config_name).param_spec(r.cell.config)
    r.mark("imports")
    trees = make_trees(pspec, tr, r.seed, dev)
    r.mark("input trees")
    elements = sum(math.prod(shape) for _, shape, _ in pspec)
    agg = Aggregator(AggConfig(**tr["agg"]), stacked=True)
    for i in range(tr["warmup_calls"]):
        agg.allreduce_tree(trees[i % len(trees)])
    n_sample, first = tr["sample_calls"]
    rng = np.random.default_rng(np.random.SeedSequence([r.seed, 2]))
    sample = set(int(i) for i in rng.choice(first, size=n_sample, replace=False))
    r.mark_setup_done()

    kept, last, issue = {}, {}, []

    def one(i):
        t0 = time.perf_counter()
        out = agg.allreduce_tree(trees[i % len(trees)])
        issue.append(time.perf_counter() - t0)
        if i in sample:
            kept[i] = out
        last["call"] = (i, out)

    r.window = common.timed_window(one, r.seconds, dev, elements)
    r.mark_window_done()
    r.issue_s = issue
    if "call" in last:
        i, out = last["call"]
        kept[i] = out
    r.attempted = r.window.count
    if r.trace and dev.type == "cuda":
        def calls(k):
            for i in range(k):
                agg.allreduce_tree(trees[i % len(trees)])

        n, m = tr["profile_calls"], tr["host_profile_calls"]
        r.profile = common.profile(lambda: calls(n), n, dev)
        r.host_profile = common.profile(lambda: calls(m), m, dev, host="aggregation call")
    r.mark_traced_done()
    del agg, one, last

    t0 = time.perf_counter()
    bad = {}
    for t, tree in enumerate(trees):
        calls = [i for i in sorted(kept) if i % len(trees) == t]
        bad.update(zip(calls, mismatches([kept[i] for i in calls], tree) if calls else []))
    r.failed = sum(1 for v in bad.values() if v)
    r.readings = {"calls_checked": sorted(bad), "mismatched": bad,
                  "reference_s": time.perf_counter() - t0}
    r.checks = {"mismatched_elements": (sum(bad.values()), limits["mismatched_elements"]),
                "calls_unchecked": (0 if bad else 1, limits["calls_unchecked"])}
