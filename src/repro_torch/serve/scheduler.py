"""Continuous-batching scheduler over a paged KV cache (torch port of
``repro.serve.scheduler``).

The static :class:`~repro_torch.serve.engine.ServeEngine` packs requests
into lockstep batches: a batch prefills together (left-padded to its
longest prompt) and occupies its dense ``(b, max_len)`` cache until its
longest slot finishes. This engine schedules per request:

- a fixed pool of ``num_slots`` decode slots; queued requests are admitted
  into free slots as soon as one opens (admission also reserves worst-case
  KV pages, so no admitted request can run out of pages mid-decode:
  exhaustion shows up as queue backpressure instead);
- prefill runs apart from the decode batch: newly admitted prompts are
  prefilled unpadded (same-length prompts in one call), their K/V copied
  into pages, and their first token taken from the prefill logits;
- one decode step advances ALL live slots through
  ``model.decode_step_paged`` (per-slot positions and page tables); a slot
  is retired the moment its request finishes, freeing its pages and slot;
- per-request TTFT/TPOT are kept in scheduler-step units (one step is one
  decode iteration), plus the wall-clock run time ``last_wall_s``.

Greedy per-request outputs equal the static engine's run one request at a
time, token for token (the model's decode is batch-invariant:
``repro_torch.models.transformer``, "Batch invariance").

Device work per scheduler event is one plain function (``_decode_fused``,
``_prefill_fused``): the pools are written in place, never copied, and the
greedy argmax stays on the device. The next decode's input tokens come
straight from the previous step's argmax (``_next``); tokens reach the host
only when their request retires (``ContinuousEngine._tok``).

Telemetry rides the ONE ``Aggregator`` facade (``TelemetryChannel``): rows
of [requests, tokens, decode steps, rejections] per retirement window.
"""
from __future__ import annotations

import dataclasses
import math
import time
import warnings
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import trace as _trace
from repro_torch.core.agg import AggConfig
from repro_torch.models.transformer import ATTN_FAMILIES
from repro_torch.serve.engine import (Request, Result, TelemetryChannel, check_request,
                                      check_servable, greedy)
from repro_torch.serve.kvcache import PagedKVCache, pages_needed, write_pages

__all__ = ["ContinuousEngine", "RequestStats"]


# ----------------------------------------------------------------------
# device work, one call per scheduler event
# ----------------------------------------------------------------------


@torch.inference_mode()
def _decode_fused(model, toks, k_pool, v_pool, table, lens) -> torch.Tensor:
    """One paged decode step (pools written in place) -> the (B, 1) int32
    greedy tokens, on the device."""
    logits, _, _ = model.decode_step_paged(toks, k_pool, v_pool, table, lens)
    return greedy(logits)


@torch.inference_mode()
def _prefill_fused(model, page: int, toks, k_pool, v_pool, pages, nxt, rows):
    """Prefill a same-length group unpadded, scatter its K/V into the
    group's pages in place, and splice the first tokens into the decode
    feedback vector. Returns (first (n,) int32, the new feedback vector).

    ``nxt`` is not written in place: it is the previous decode step's
    output and stays in the step history until every slot that refers to
    it retires (the reference does not donate it either)."""
    n, s = toks.shape
    logits, cache = model.prefill(toks, model.init_cache(n, s, rows=n))
    first = greedy(logits)[:, 0]
    write_pages(k_pool, cache.kv.k, pages, page)
    write_pages(v_pool, cache.kv.v, pages, page)
    return first, nxt.index_put((rows, torch.zeros_like(rows)), first)


@dataclasses.dataclass
class RequestStats:
    """Per-request serving latencies, in scheduler-step time units."""
    rid: int
    t_arrival: float
    t_admitted: float = math.nan
    t_first_token: float = math.nan
    t_finish: float = math.nan
    n_prompt: int = 0
    n_generated: int = 0

    @property
    def ttft(self) -> float:
        """Time to first token: queueing delay + prefill (prefill costs the
        step it happens in)."""
        return self.t_first_token - self.t_arrival

    @property
    def tpot(self) -> float:
        """Time per output token after the first (nan for 1-token requests)."""
        if self.n_generated <= 1:
            return math.nan
        return (self.t_finish - self.t_first_token) / (self.n_generated - 1)


@dataclasses.dataclass
class _Slot:
    req: Request
    budget: int          # effective max_new_tokens (post-admission)
    cache_len: int       # tokens currently in the paged cache
    reserved_pages: int  # worst-case pages charged at admission
    # generated tokens as (step id, index) refs into the on-device step
    # history, read to the host only at retirement
    tokens: List[Tuple[int, int]]


class ContinuousEngine:
    """Throughput-first serving engine: continuous batching + paged KV.

    Same admission rule as the static engine (``engine.check_request``), so
    the two engines see the same effective workload; in addition a request
    whose worst case exceeds the whole page pool is rejected up front, and a
    request that fits eventually but not now waits in the queue
    (backpressure, never out of memory). ``model`` is a ``repro_torch``
    model; the pools live on its device.
    """

    def __init__(self, model, num_slots: int, max_len: int, page_size: int = 16,
                 num_pages: Optional[int] = None, agg: AggConfig | None = None,
                 group=None, max_prefill_per_step: Optional[int] = None):
        check_servable(model.cfg)
        if model.cfg.family not in ATTN_FAMILIES:
            raise ValueError(
                f"model family {model.cfg.family!r} has no paged decode path; "
                f"use the static ServeEngine")
        self.model = model
        self.num_slots = num_slots
        self.max_len = max_len
        self.device = model.device
        self.cache = PagedKVCache(model.cfg, num_slots, max_len, page_size,
                                  num_pages=num_pages, device=self.device)
        self._next = torch.zeros((num_slots, 1), dtype=torch.int32, device=self.device)
        self._hist: Dict[int, torch.Tensor] = {}   # step id -> device tokens
        self._hist_np: Dict[int, np.ndarray] = {}
        self._sid = 0
        self.max_prefill_per_step = max_prefill_per_step or num_slots
        self.slots: List[Optional[_Slot]] = [None] * num_slots
        self.queue: deque[Tuple[float, Request]] = deque()
        self.now = 0.0
        self.stats: Dict[int, RequestStats] = {}
        self._reserved_total = 0
        self.telemetry = {
            "requests": 0, "tokens_generated": 0, "decode_steps": 0,
            "prefills": 0, "prefill_tokens": 0, "rejected": 0,
            "truncated": 0, "admitted": 0, "retired": 0, "queue_peak": 0,
            "slot_steps": 0,
        }
        self.telemetry_channel = None
        if agg is not None:
            # [requests, tokens, decode steps, rejections] per flush window
            self.telemetry_channel = TelemetryChannel(agg, ncols=4, group=group,
                                                      device=self.device)
        self._window = {"rows": [], "decode_steps": 0, "rejected": 0}

    @property
    def aggregator(self):
        ch = self.telemetry_channel
        return None if ch is None else ch.aggregator

    # --- public API ----------------------------------------------------------

    def submit(self, req: Request, t_arrival: Optional[float] = None) -> bool:
        """Queue a request (admission-checked). Returns False if rejected."""
        t = self.now if t_arrival is None else t_arrival
        r = self._check(req)
        if r is None:
            return False
        self.stats[r.rid] = RequestStats(rid=r.rid, t_arrival=t, n_prompt=len(r.prompt))
        self.queue.append((t, r))
        self.telemetry["queue_peak"] = max(self.telemetry["queue_peak"], len(self.queue))
        return True

    def run(self, requests: Sequence[Request]) -> List[Result]:
        """Serve a closed batch of requests all arriving at t=0."""
        return self.run_trace([(0.0, r) for r in requests])

    def run_trace(self, arrivals: Sequence[Tuple[float, Request]]) -> List[Result]:
        """Serve a timed trace of (arrival_time, request) pairs (time in
        scheduler-step units, e.g. from ``repro_torch.serve.loadgen``).
        Returns results in COMPLETION order; per-request latencies land in
        ``self.stats[rid]``, the wall-clock run time in ``self.last_wall_s``."""
        pending = deque(sorted(arrivals, key=lambda a: a[0]))
        results: List[Result] = []
        t0 = time.perf_counter()
        guard = 0
        limit = 16 * (len(pending) + 1) * (self.max_len + 2)
        while pending or self.queue or any(self.slots):
            guard += 1
            if guard > limit:  # pragma: no cover - scheduler invariant
                raise RuntimeError("scheduler failed to drain the trace")
            while pending and pending[0][0] <= self.now:
                t, r = pending.popleft()
                self.submit(r, t)
            results.extend(self._admit_from_queue())
            if not any(self.slots):
                if self.queue:
                    # an empty slot table means no page is held, and _check
                    # caps worst cases at the pool: the head is admissible
                    continue
                if pending:
                    self.now = max(self.now + 1.0, float(math.ceil(pending[0][0])))
                    continue
                break
            results.extend(self._decode_step())
        self._flush_telemetry()
        self._hist.clear()       # all slots retired: history fully drained
        self._hist_np.clear()
        self.last_wall_s = time.perf_counter() - t0
        return results

    # --- admission -----------------------------------------------------------

    def _count(self, key: str) -> None:
        if key == "rejected":
            self._reject()
        else:
            self.telemetry[key] += 1

    def _check(self, r: Request) -> Optional[Request]:
        """The static engine's admission rule + a whole-pool feasibility
        check; returns the (possibly truncated) request or None."""
        r = check_request(r, self.max_len, self._count)
        if r is None:
            return None
        if self._worst_case_pages(len(r.prompt), r.max_new_tokens) > \
                self.cache.allocator.num_pages:
            warnings.warn(
                f"request {r.rid}: needs more KV pages than the whole pool "
                f"({self.cache.allocator.num_pages}); rejected")
            self._reject()
            return None
        return r

    def _reject(self):
        self.telemetry["rejected"] += 1
        self._window["rejected"] += 1

    def _worst_case_pages(self, plen: int, budget: int) -> int:
        # positions used: prompt [0, plen) plus budget-1 decode writes (the
        # first generated token rides the prefill logits)
        return pages_needed(plen + budget - 1, self.cache.page_size)

    def _admit_from_queue(self) -> List[Result]:
        """Admit queue-head requests into free slots while both a slot and
        the worst-case page reservation are available (FIFO, so admission
        order is deterministic). Same-length prompts admitted in the same
        step share one prefill call. Returns results for requests whose
        budget is 1 (their token rides the prefill)."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        picked: List[Tuple[int, float, Request]] = []
        while free and self.queue and len(picked) < self.max_prefill_per_step:
            t_arr, r = self.queue[0]
            wc = self._worst_case_pages(len(r.prompt), r.max_new_tokens)
            if self._reserved_total + wc > self.cache.allocator.num_pages:
                break  # backpressure: the head waits for pages to free up
            self.queue.popleft()
            self._reserved_total += wc
            picked.append((free.pop(0), t_arr, r))
        results: List[Result] = []
        by_len: Dict[int, List[Tuple[int, float, Request]]] = {}
        for slot, t_arr, r in picked:
            by_len.setdefault(len(r.prompt), []).append((slot, t_arr, r))
        for plen, group in sorted(by_len.items()):
            results.extend(self._prefill_group(plen, group))
        return results

    def _prefill_group(self, plen: int,
                       group: List[Tuple[int, float, Request]]) -> List[Result]:
        n = len(group)
        toks = np.stack([r.prompt for _, _, r in group]).astype(np.int32)
        npg = pages_needed(plen, self.cache.page_size)
        rows, pages = [], []
        for slot, _, r in group:
            if not self.cache.grow_slot(slot, plen):
                raise RuntimeError("page reservation does not cover a prompt")
            rows.append(slot)
            pages.extend(self.cache.slot_pages(slot)[:npg])
        dev = self.device
        with _trace.span("serve.prefill", phase="prefill", n=n, plen=plen,
                         elems=n * plen) as sp:
            first, self._next = _prefill_fused(
                self.model, self.cache.page_size, torch.from_numpy(toks).to(dev),
                self.cache.k, self.cache.v, torch.tensor(pages, device=dev), self._next,
                torch.tensor(rows, device=dev))
            sp.sync(first)
        sid = self._sid
        self._sid += 1
        self._hist[sid] = first
        self.telemetry["prefills"] += 1
        self.telemetry["prefill_tokens"] += n * plen
        results: List[Result] = []
        for i, (slot, _, r) in enumerate(group):
            st = self.stats[r.rid]
            st.t_admitted = self.now
            st.t_first_token = self.now
            s = _Slot(req=r, budget=r.max_new_tokens, cache_len=plen,
                      reserved_pages=self._worst_case_pages(plen, r.max_new_tokens),
                      tokens=[(sid, i)])
            self.telemetry["admitted"] += 1
            if s.budget == 1:
                # its one token rode the prefill: it retires without
                # entering the decode batch
                results.append(self._retire(slot, s))
            else:
                self.slots[slot] = s
        return results

    # --- decode --------------------------------------------------------------

    def _decode_step(self) -> List[Result]:
        """One lockstep decode over every slot (idle slots ride along on the
        scratch page; their tokens are dropped). Its input tokens are the
        previous step's on-device argmax (``self._next``)."""
        active = [i for i, s in enumerate(self.slots) if s is not None]
        lens = np.zeros((self.num_slots,), np.int64)
        for i in active:
            s = self.slots[i]
            if not self.cache.grow_slot(i, s.cache_len + 1):
                raise RuntimeError("page reservation does not cover decode growth")
            lens[i] = s.cache_len
        with _trace.span("serve.decode", phase="decode", active=len(active)) as sp:
            self._next = _decode_fused(self.model, self._next, self.cache.k, self.cache.v,
                                       self.cache.device_table(),
                                       torch.from_numpy(lens).to(self.device))
            sp.sync(self._next)
        sid = self._sid
        self._sid += 1
        self._hist[sid] = self._next
        self.now += 1.0
        self.telemetry["decode_steps"] += 1
        self.telemetry["slot_steps"] += len(active)
        self._window["decode_steps"] += 1
        results: List[Result] = []
        for i in active:
            s = self.slots[i]
            s.cache_len += 1
            s.tokens.append((sid, i))
            if len(s.tokens) >= s.budget:
                results.append(self._retire(i, s))
                self.slots[i] = None
        return results

    # --- retirement + telemetry ---------------------------------------------

    def _tok(self, sid: int, idx: int) -> int:
        """One generated token from the on-device step history (each step's
        token vector is copied to the host at most once)."""
        buf = self._hist_np.get(sid)
        if buf is None:
            buf = self._hist[sid].cpu().numpy().ravel()
            self._hist_np[sid] = buf
        return int(buf[idx])

    def _retire(self, slot: int, s: _Slot) -> Result:
        self.cache.release_slot(slot)
        self._reserved_total -= s.reserved_pages
        st = self.stats[s.req.rid]
        st.t_finish = self.now
        st.n_generated = len(s.tokens)
        self.telemetry["retired"] += 1
        res = Result(rid=s.req.rid,
                     tokens=np.asarray([self._tok(sid, i) for sid, i in s.tokens], np.int32))
        if self.telemetry_channel is None:
            self.telemetry["requests"] += 1
            self.telemetry["tokens_generated"] += len(res.tokens)
        else:
            self._window["rows"].append((1.0, float(len(res.tokens))))
            if len(self._window["rows"]) >= self.num_slots:
                self._flush_telemetry()
        return res

    def _flush_telemetry(self):
        """Push the window's [requests, tokens, decode steps, rejections]
        through the facade (when configured) and fold them into the totals:
        one facade reduction per retirement window."""
        w = self._window
        if self.telemetry_channel is None:
            return
        if not (w["rows"] or w["decode_steps"] or w["rejected"]):
            return
        rows = [(nreq, ntok, 0.0, 0.0) for nreq, ntok in w["rows"]]
        rows.append((0.0, 0.0, float(w["decode_steps"]), float(w["rejected"])))
        n_req, n_tok, _steps, _rej = self.telemetry_channel.reduce(rows)
        self.telemetry["requests"] += n_req
        self.telemetry["tokens_generated"] += n_tok
        self._window = {"rows": [], "decode_steps": 0, "rejected": 0}

    # --- reporting -----------------------------------------------------------

    def latency_stats(self) -> List[RequestStats]:
        return [st for st in self.stats.values() if not math.isnan(st.t_finish)]
