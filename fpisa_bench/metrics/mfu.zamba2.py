"""The Zamba2 training step's share of the card's bf16 peak: the
benchmark's flop count of the hybrid's forward and backward
(``counts_zamba2.train_flops_per_token``: 6 per matrix-product parameter,
each shared-block application, adapter and ``W_lin`` and the tied head
counted; attention's kept pairs; the SSD's chunked contractions; recompute
not counted) for every token of the traced run's window, over that
window's seconds, in %."""
from fpisa_bench import counts, counts_zamba2

SOURCE = "host_clock"
MOVES = "train_tok_s"


def read(r):
    if not r.window.count:
        return None
    per_token = counts_zamba2.train_flops_per_token(r.cell.config, r.cell.traffic["seq"])
    return 100 * r.window.units * per_token / r.window.seconds / counts.PEAK_FLOPS_BF16
