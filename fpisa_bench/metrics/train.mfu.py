"""The training step's share of the card's bf16 peak: the benchmark's flop
count of a dense decoder's forward and backward (``counts.
dense_train_flops_per_token``: 6 per matrix-product parameter, the tied
head included, and causal attention; recompute not counted) for every
token of the traced run's window, over that window's seconds."""
from fpisa_bench import counts

SOURCE = "host_clock"
MOVES = "train_tok_s"


def read(r):
    if not r.window.count:
        return None
    c, t = r.cell.config, r.cell.traffic
    d, h = c["hidden_size"], c["num_attention_heads"]
    per_token = counts.dense_train_flops_per_token(
        d, h, c["num_key_value_heads"], d // h, c["intermediate_size"],
        c["num_hidden_layers"], c["vocab_size"], t["seq"])
    return 100 * r.window.units * per_token / r.window.seconds / counts.PEAK_FLOPS_BF16
