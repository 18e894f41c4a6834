"""Phase replay profiler: measure encode/collective/finish at probe sizes
(torch port of ``repro.autotune.profile``).

The cost model (``costmodel.py``) fits per-phase time as a function of
bucket size; this module produces those measurements by replaying the
strategy's split-phase pipeline, the SAME registry hooks the bucketer
dispatches through (``StrategySpec.flat_phases``), on the port's device,
each phase timed under a synced tracer span::

    autotune.probe {phase: encode,     elems: n, synced: True}
    autotune.probe {phase: collective, elems: n, synced: True}
    autotune.probe {phase: finish,     elems: n, synced: True}

Each phase is waited on individually (the span's sync), so the spans
measure the device time of each phase, not its launch; warm-up iterations
take the kernels' first-use build. Replay serializes what the bucketer
overlaps, so the fitted costs are per phase, and the pipeline recurrence
of the cost model puts the overlap back.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch import trace as _trace
from repro_torch.core.agg import AggConfig, get_strategy, resolve_backend
from repro_torch.core.bucketer import _stage_dtype


def probe_sizes(*, block: int = 256, n_probes: int = 6,
                max_elems: int = 1 << 20) -> tuple[int, ...]:
    """Geometric block-multiple probe grid from one block up to
    ``max_elems``, wide enough that the fit separates fixed from
    per-element cost."""
    sizes, n = [], block
    while n <= max_elems and len(sizes) < n_probes:
        sizes.append(n)
        n *= 4
    return tuple(sizes)


def profile_phases(cfg: AggConfig | None = None, *,
                   sizes: Sequence[int] | None = None, group=None,
                   device=None, iters: int = 3, warmup: int = 1, seed: int = 0,
                   tracer: "_trace.Tracer | None" = None) -> list[dict]:
    """Replay the flat split-phase pipeline at each probe size; returns the
    recorded span dicts (also left on the tracer used).

    ``group`` is the process group the collective runs over (None: the
    default group, or a world of one with no process group); ``device``
    None means the card. Spans land on ``tracer`` when given, else the
    enabled global tracer, else a private one."""
    cfg = cfg or AggConfig(strategy="fpisa")
    spec = get_strategy(cfg.strategy)
    if spec.flat_phases is None:
        raise ValueError(
            f"strategy {cfg.strategy!r} has no split-phase pipeline hooks; "
            f"the phase profiler can only replay split-phase strategies "
            f"(e.g. fpisa)")
    device = resolve_device(device)
    backend = resolve_backend(cfg.backend, device)
    sizes = tuple(sizes) if sizes is not None else probe_sizes(block=cfg.block)
    for n in sizes:
        if n % cfg.block:
            raise ValueError(
                f"probe sizes must be block multiples (block={cfg.block}), "
                f"got {n}")

    tr = tracer
    if tr is None:
        tr = _trace.get() if _trace.enabled() else _trace.Tracer()

    encode, collect, finish = spec.flat_phases(group, cfg, backend)
    stage = _stage_dtype(cfg, "float32")
    rng = np.random.default_rng(seed)
    start = len(tr.spans)
    for n in sizes:
        x = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 0.01)
        x = x.to(device=device, dtype=stage)
        for _ in range(warmup):
            _trace.wait_for(finish(collect(encode(x))))
        for _ in range(iters):
            with tr.span("autotune.probe", phase="encode", elems=n,
                         strategy=cfg.strategy, backend=backend) as sp:
                state = sp.sync(encode(x))
            with tr.span("autotune.probe", phase="collective", elems=n,
                         strategy=cfg.strategy, backend=backend) as sp:
                collected = sp.sync(collect(state))
            with tr.span("autotune.probe", phase="finish", elems=n,
                         strategy=cfg.strategy, backend=backend) as sp:
                sp.sync(finish(collected))
    return tr.spans[start:]
