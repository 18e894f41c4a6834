"""Static-batch serving engine (torch port of ``repro.serve.engine``).

Requests arrive with prompts and are packed into a fixed batch: one prefill
fills the batch's dense cache, and greedy decode steps advance every live
slot. The continuous-batching engine (``repro_torch.serve.scheduler``)
replaces the lockstep batch with slot-level admission over a paged KV cache
and uses THIS engine, run one request at a time, as its oracle: greedy
per-request outputs must match token for token.

Telemetry rides the same ``Aggregator`` facade as the trainers: per-batch
counters (requests, generated tokens) are reduced over the process group
through ONE :class:`~repro_torch.core.agg.Aggregator`
(:class:`TelemetryChannel`, shared by both engines), so ``fpisa`` telemetry
launches K1/K2 on the card and ``fpisa_seq`` telemetry launches K6, and a
wrong ``--agg-strategy`` fails when the engine is built.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core.agg import AggConfig, Aggregator, group_rank, world_size
from repro_torch.models.transformer import select_rows


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16


@dataclasses.dataclass
class Result:
    rid: int
    tokens: np.ndarray


class TelemetryChannel:
    """Rows of per-request counters reduced to global totals through ONE
    :class:`Aggregator` over ``group`` (None: the default group, or a world
    of one). Row j goes to rank ``j % world``, as the reference's shard
    ``j % d`` takes request j's counters; at world 1 every row is summed
    into this rank's row. ``reductions`` counts the calls of ``reduce``."""

    def __init__(self, agg: AggConfig, ncols: int, group=None, device=None):
        self.ncols = ncols
        self.group = group
        self.device = torch.device("cpu") if device is None else torch.device(device)
        # the ONE facade instance of this serving path: strategy lookup and
        # capability checks happen here, when the engine is built
        self.aggregator = Aggregator(agg, group)
        self.reductions = 0

    def reduce(self, per_request_rows: Sequence[Sequence[float]]) -> List[int]:
        """Reduce a batch of per-request counter rows to global totals."""
        d = world_size(self.group)
        rows = np.zeros((d, self.ncols), np.float32)
        for j, r in enumerate(per_request_rows):
            rows[j % d] += np.asarray(r, np.float32)
        mine = torch.tensor(rows[group_rank(self.group)], device=self.device)
        totals = self.aggregator.allreduce(mine).cpu().numpy()
        self.reductions += 1
        # round, don't truncate: narrow-wire strategies quantize (8.0 can
        # come back 7.9999995) and int() would undercount permanently
        return [int(round(float(t))) for t in totals]


def check_request(r: Request, max_len: int, count) -> Request | None:
    """The engines' shared admission rule: an empty prompt, or one longer
    than ``max_len``, is refused (``count("rejected")``); a budget past the
    cache (``max_len - len(prompt) + 1`` tokens fit: the first generated
    token rides the prefill logits) is truncated to what fits
    (``count("truncated")``), with a warning."""
    plen = len(r.prompt)
    if plen == 0:
        warnings.warn(f"request {r.rid}: zero-length prompt; rejected")
        count("rejected")
        return None
    if plen > max_len:
        warnings.warn(
            f"request {r.rid}: prompt length {plen} exceeds engine "
            f"max_len={max_len}; rejected")
        count("rejected")
        return None
    fit = max_len - plen + 1
    if r.max_new_tokens > fit:
        warnings.warn(
            f"request {r.rid}: max_new_tokens={r.max_new_tokens} "
            f"does not fit the KV cache after a {plen}-token prompt; "
            f"truncated to {fit}")
        count("truncated")
        r = dataclasses.replace(r, max_new_tokens=fit)
    return r


def check_servable(cfg) -> None:
    """The engines feed prompts alone to ``prefill``. The encoder-decoder
    (audio) family's prefill also needs audio frames, so both engines
    refuse it, as the reference's cannot serve it either (its static
    engine fails on the missing frames, its continuous engine refuses a
    family without a paged decode path)."""
    if cfg.is_encoder_decoder:
        raise ValueError(
            f"model family {cfg.family!r} ({cfg.name}) is an encoder-decoder whose prefill "
            f"needs audio frames; the serving engines feed prompts only and cannot serve it")


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, 1, V) logits -> (B, 1) int32 argmax tokens, on their device."""
    return logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)


class ServeEngine:
    """Static-batch engine: groups requests into batches of ``batch_size``,
    prefills them together (left-padded to the batch's longest prompt),
    then decodes greedily until all finish. Finished slots are RETIRED from
    the lockstep batch (the decode batch shrinks to the still-live slots),
    so per-slot work stops at that slot's own budget.

    ``model`` is a ``repro_torch`` model (its parameters live on it); the
    engine runs on the model's device."""

    def __init__(self, model, batch_size: int, max_len: int,
                 agg: AggConfig | None = None, group=None):
        check_servable(model.cfg)
        self.model = model
        self.batch_size = batch_size
        self.max_len = max_len
        self.device = model.device
        self.telemetry = {"requests": 0, "tokens_generated": 0, "batches": 0,
                          "decode_steps": 0, "rejected": 0, "truncated": 0,
                          "truncated_by_packing": 0, "slot_steps": 0}
        self.telemetry_channel = None
        if agg is not None:
            # totals of [requests, generated tokens] per batch
            self.telemetry_channel = TelemetryChannel(agg, ncols=2, group=group,
                                                      device=self.device)

    @property
    def aggregator(self):
        ch = self.telemetry_channel
        return None if ch is None else ch.aggregator

    def run(self, requests: List[Request]) -> List[Result]:
        admitted = self._admit(requests)
        out: List[Result] = []
        for i in range(0, len(admitted), self.batch_size):
            out.extend(self._run_batch(admitted[i : i + self.batch_size]))
        return out

    def _count(self, key: str) -> None:
        self.telemetry[key] += 1

    def _admit(self, requests: List[Request]) -> List[Request]:
        """KV-cache admission control (``check_request``): without it an
        over-length request would run past the cache's last position."""
        checked = (check_request(r, self.max_len, self._count) for r in requests)
        return [r for r in checked if r is not None]

    def _record_telemetry(self, reqs: List[Request], results: List[Result]):
        """Fold one batch into the running totals: through the aggregation
        facade when configured, on the host otherwise."""
        n_req = len(reqs)
        n_tok = sum(len(r.tokens) for r in results)
        if self.telemetry_channel is not None:
            n_req, n_tok = self.telemetry_channel.reduce(
                [(1.0, len(res.tokens)) for res in results])
        self.telemetry["requests"] += n_req
        self.telemetry["tokens_generated"] += n_tok
        self.telemetry["batches"] += 1

    def _run_batch(self, reqs: List[Request]) -> List[Result]:
        b = len(reqs)
        plen = max(len(r.prompt) for r in reqs)
        toks = np.zeros((b, plen), np.int32)
        for j, r in enumerate(reqs):
            toks[j, plen - len(r.prompt):] = r.prompt  # left-pad
        cache = self.model.init_cache(b, self.max_len)
        logits, cache = self.model.prefill(torch.from_numpy(toks).to(self.device), cache)
        new = greedy(logits)
        # every slot's cache region starts at the BATCH prompt length
        # (left-padding): slot j holds at most max_len - plen + 1 tokens,
        # however generous its own admission-time budget was; counted
        effs = [min(r.max_new_tokens, self.max_len - plen + 1) for r in reqs]
        self.telemetry["truncated_by_packing"] += sum(
            1 for r, e in zip(reqs, effs) if e < r.max_new_tokens)
        # the retirement schedule is static (greedy budgets are known up
        # front): after step t every slot with effs[j] <= t is done and is
        # sliced OUT of the lockstep batch
        live = list(range(b))                    # original slot indices
        steps = [(list(live), new)]              # (live slots, (len, 1) tokens)
        t = 1                                    # tokens generated per slot
        while t < max(effs):
            keep = [i for i, j in enumerate(live) if effs[j] > t]
            if len(keep) < len(live):
                live = [live[i] for i in keep]
                new = new[torch.tensor(keep, device=self.device)]
                cache = select_rows(cache, keep)
            logits, cache = self.model.decode_step(new, cache)
            new = greedy(logits)
            steps.append((list(live), new))
            self.telemetry["slot_steps"] += len(live)
            t += 1
        self.telemetry["decode_steps"] += t - 1
        rows: List[List[int]] = [[] for _ in range(b)]
        for live_j, col in steps:
            col_np = col.cpu().numpy()
            for i, j in enumerate(live_j):
                if len(rows[j]) < effs[j]:
                    rows[j].append(col_np[i, 0])
        results = [Result(rid=r.rid, tokens=np.asarray(rows[j], np.int32))
                   for j, r in enumerate(reqs)]
        self._record_telemetry(reqs, results)
        return results
