"""Paged KV cache: fixed-size pages from a global pool + per-slot page tables
(torch port of ``repro.serve.kvcache``).

The static engine allocates a dense ``(batch, max_len)`` KV region per batch,
so memory scales with the worst case even when most slots hold short
requests. Here the KV store is a global pool of ``num_pages`` fixed-size
pages (``page_size`` token positions each, spanning all layers), and each
decode slot owns only the pages that cover its live tokens:

- ``PageAllocator`` is the host-side free list. It hands out page ids,
  refuses double-frees loudly, and tracks ``in_use`` / ``peak_in_use`` so a
  run can report real footprint against the dense baseline.
- ``PagedKVCache`` owns the device pools ``(L, 1 + num_pages, page, K, hd)``
  and the host page-table mirror ``(num_slots, pages_per_slot)``. Page id 0
  is a reserved scratch page: empty slots point every table entry at it, so
  the lockstep decode step can scatter their (discarded) K/V writes
  somewhere harmless without branching. Page 0 is never allocated and never
  read by a live slot.

With ``pages_per_slot * page_size == max_len``, gathering a slot's pages
yields a ``(max_len, K, hd)`` view whose allocated positions hold exactly
the values a dense per-slot cache would hold, and whose unallocated
positions are masked to -1e30 before the softmax (``exp`` underflows them to
exactly 0.0), so paged decode equals dense decode bit for bit.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import dtype_of

__all__ = ["PageAllocator", "PagedKVCache", "pages_needed", "write_pages"]


def pages_needed(n_tokens: int, page_size: int) -> int:
    """Pages required to hold ``n_tokens`` cache positions."""
    return -(-max(n_tokens, 0) // page_size)


def write_pages(pool: torch.Tensor, kv: torch.Tensor, pages: torch.Tensor,
                page_size: int) -> None:
    """Scatter the K (or V) of n same-length prompts, ``kv`` (L, n, s, K,
    hd), into the pool's pages ``pages`` (the n prompts' pages in order,
    ``pages_needed(s)`` each), in place. The tail of each prompt's last page
    is zero-padded; decode overwrites those positions before they are ever
    unmasked."""
    n, s = kv.shape[1:3]
    npg = pages_needed(s, page_size)
    if npg * page_size > s:
        kv = F.pad(kv, (0, 0, 0, 0, 0, npg * page_size - s))
    pool[:, pages] = kv.reshape(kv.shape[0], n * npg, page_size, *kv.shape[3:]).to(pool.dtype)


class PageAllocator:
    """Host-side free list over page ids ``1..num_pages`` (0 is scratch).

    Invariants:
      - a page is never handed out twice while allocated;
      - freeing a page that is not allocated raises (no double-free);
      - ``alloc`` returns ``None`` on exhaustion (callers turn that into
        queue backpressure) and never allocates part of a request;
      - freed pages are reused, lowest id first.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 1:
            raise ValueError(f"need at least one page, got {num_pages}")
        self.num_pages = num_pages
        self.page_size = page_size
        # pop() takes from the tail: kept sorted descending, the lowest free
        # id is handed out first
        self._free: List[int] = list(range(num_pages, 0, -1))
        self._allocated: set[int] = set()
        self.peak_in_use = 0

    @property
    def in_use(self) -> int:
        return len(self._allocated)

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages, or return None (backpressure) if they are
        not all available."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._allocated.update(pages)
        self.peak_in_use = max(self.peak_in_use, len(self._allocated))
        return pages

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if p not in self._allocated:
                raise ValueError(
                    f"double free (or foreign free) of page {p}: not allocated")
            self._allocated.remove(p)
        self._free = sorted(set(self._free) | set(pages), reverse=True)


class PagedKVCache:
    """Device KV pools + per-slot page tables for a layer-stacked decoder.

    Pools are ``(num_layers, 1 + num_pages, page_size, kv_heads, head_dim)``
    on ``device`` in the activation dtype, one page table shared by every
    layer (a page id addresses the same token span in each). The page table
    lives on the host as numpy; ``device_table()`` uploads it only after it
    changed.
    """

    def __init__(self, cfg, num_slots: int, max_len: int, page_size: int,
                 num_pages: Optional[int] = None, device=None):
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(
                f"paged KV serving supports attention-KV families "
                f"(dense/moe/vlm); got family={cfg.family!r}")
        if max_len % page_size:
            raise ValueError(
                f"page_size={page_size} must divide max_len={max_len} so the "
                f"gathered page view lines up with the dense cache")
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.page_size = page_size
        self.pages_per_slot = max_len // page_size
        if num_pages is None:
            num_pages = num_slots * self.pages_per_slot  # dense-equivalent
        self.allocator = PageAllocator(num_pages, page_size)
        self.device = torch.device("cpu") if device is None else torch.device(device)
        shape = (cfg.num_layers, 1 + num_pages, page_size, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        dt = dtype_of(cfg.activation_dtype)
        with torch.inference_mode():
            self.k = torch.zeros(shape, dtype=dt, device=self.device)
            self.v = torch.zeros(shape, dtype=dt, device=self.device)
        # host mirror; 0 = scratch page
        self.page_table = np.zeros((num_slots, self.pages_per_slot), np.int64)
        self._slot_pages: List[List[int]] = [[] for _ in range(num_slots)]
        self._dev_table = None  # device copy, dropped on table writes

    # --- slot lifecycle ----------------------------------------------------

    def slot_pages(self, slot: int) -> List[int]:
        return list(self._slot_pages[slot])

    def grow_slot(self, slot: int, n_tokens: int) -> bool:
        """Ensure ``slot`` owns pages covering positions [0, n_tokens).
        Returns False (backpressure) when the pool cannot supply them."""
        need = pages_needed(n_tokens, self.page_size)
        have = len(self._slot_pages[slot])
        if need > self.pages_per_slot:
            raise ValueError(
                f"slot {slot}: {n_tokens} tokens need {need} pages > "
                f"pages_per_slot={self.pages_per_slot}")
        if need <= have:
            return True
        pages = self.allocator.alloc(need - have)
        if pages is None:
            return False
        self.page_table[slot, have:need] = pages
        self._slot_pages[slot].extend(pages)
        self._dev_table = None
        return True

    def release_slot(self, slot: int) -> None:
        """Retire a slot: return its pages to the pool and point its table
        back at the scratch page. The pool keeps stale values; every read
        masks by slot length."""
        if self._slot_pages[slot]:
            self.allocator.free(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self.page_table[slot, :] = 0
        self._dev_table = None

    # --- writes ------------------------------------------------------------

    @torch.inference_mode()
    def write_prompt(self, slot: int, k_prompt: torch.Tensor, v_prompt: torch.Tensor) -> None:
        """Copy a prefilled dense cache region into this slot's pages, in
        place.

        ``k_prompt``/``v_prompt``: ``(L, s, K, hd)``, layer-stacked K/V of
        one request's prompt (positions [0, s)), to ``write_pages``."""
        npg = pages_needed(k_prompt.shape[1], self.page_size)
        pages = torch.tensor(self._slot_pages[slot][:npg], dtype=torch.int64,
                             device=self.device)
        write_pages(self.k, k_prompt[:, None], pages, self.page_size)
        write_pages(self.v, v_prompt[:, None], pages, self.page_size)

    # --- stats -------------------------------------------------------------

    @property
    def pages_in_use(self) -> int:
        return self.allocator.in_use

    @property
    def peak_pages_in_use(self) -> int:
        return self.allocator.peak_in_use

    @property
    def dense_equivalent_tokens(self) -> int:
        """What the static engine's dense allocation would pin for the same
        slot count: ``num_slots * max_len`` cache positions."""
        return self.num_slots * self.max_len

    def device_table(self) -> torch.Tensor:
        """Device copy of the page table, re-uploaded only after a table
        write (grow/release)."""
        if self._dev_table is None:
            self._dev_table = torch.tensor(self.page_table, device=self.device)
        return self._dev_table
