"""In-switch query operators (paper Sec. 6) on the device (port of
``repro.switchsim.query``).

* ``topn_keep`` — per row batch: encode the column, broadcast the threshold
  planes, FPISA compare (subtract + sign test, integer-only) — the
  switch-side half of Cheetah-style Top-N pruning.
* ``groupby_ingest`` — scatter-accumulate a (keys, values) row batch into
  per-group FPISA accumulator slots with per-slot sequential semantics
  (rows of one key apply in batch order), through the same rank table as
  ``dataplane.ingest_batch``. A per-slot ``since`` counter flushes the
  register (renormalize + re-encode) every ``flush_every`` adds (the
  paper's Sec. 3.3 headroom bound: about 128 same-scale adds fit 7 headroom
  bits; flushing at 64 keeps a 2x margin).

Both run as torch operations on their inputs' device. As in
``dataplane.ingest_batch``, the reference's ``lax.scan`` over the rank
table's columns is a Python loop over them, and its ``lax.cond`` on "some
slot is due a flush" is computed every round and selected with
``torch.where`` (same bits; it costs one renormalize + encode of the S slot
registers per round, also on the rounds where no slot is due). Nothing in
the loop waits on the device.

Group-by uses the ``full`` FPISA add by default: query aggregation needs the
RSAW extension rather than the FPISA-A approximation (Sec. 6.1).
"""
from __future__ import annotations

import torch

from repro_torch.core import fpisa
from repro_torch.switchsim.dataplane import _rank_table


def topn_keep(values: torch.Tensor, thresh_exp, thresh_man, *,
              fmt_name: str = "fp32") -> torch.Tensor:
    """(B,) packed FP column vs scalar threshold planes -> (B,) bool keep
    mask (value > threshold), computed as FPISA subtraction + sign test."""
    fmt = fpisa.FORMATS[fmt_name]
    planes = fpisa.encode(values, fmt)
    t_exp = torch.as_tensor(thresh_exp, dtype=torch.int32, device=values.device)
    t_man = torch.as_tensor(thresh_man, dtype=torch.int32, device=values.device)
    diff, _ = fpisa.fpisa_add_full(
        planes, fpisa.Planes(t_exp.expand_as(planes.exp), (-t_man).expand_as(planes.man)),
        fmt)
    return diff.man > 0


def groupby_ingest(exp, man, since, keys, values, valid, *, num_slots: int,
                   rounds: int, variant: str = "full", flush_every: int = 64,
                   fmt_name: str = "fp32"):
    """Accumulate a row batch into per-group FPISA slots.

    Args (tensors on one device):
      exp/man:  (S,) int32 accumulator planes (S = num_slots).
      since:    (S,) int32 adds since the slot's last flush.
      keys:     (B,) integer group keys in [0, S).
      values:   (B,) packed FP column.
      valid:    (B,) bool row mask.
      rounds:   max rows of one key this call applies (>= the batch's
                max per-key multiplicity, or the remainder is deferred).

    Returns (exp, man, since, deferred)."""
    fmt = fpisa.FORMATS[fmt_name]
    add = fpisa.fpisa_add_full if variant == "full" else fpisa.fpisa_a_add
    planes = fpisa.encode(values, fmt)
    table, deferred = _rank_table(keys.long(), valid, num_slots, rounds)

    for r in range(rounds):  # lax.scan over the table's columns
        pidx = table[:, r]
        active = pidx >= 0
        pi = torch.where(active, pidx, 0).long()
        inp = fpisa.Planes(planes.exp[pi], planes.man[pi])
        newp, _ = add(fpisa.Planes(exp, man), inp, fmt)
        exp = torch.where(active, newp.exp, exp)
        man = torch.where(active, newp.man, man)
        since = torch.where(active, since + 1, since)
        # periodic flush: renormalize + re-encode the register so long-running
        # slots never exhaust the int32 headroom (lax.cond(any(flush)) ->
        # computed every round, selected by where)
        flush = since >= flush_every
        fp = fpisa.encode(fpisa.renormalize(fpisa.Planes(exp, man), fmt), fmt)
        exp = torch.where(flush, fp.exp, exp)
        man = torch.where(flush, fp.man, man)
        since = torch.where(flush, 0, since)
    return exp, man, since, deferred
