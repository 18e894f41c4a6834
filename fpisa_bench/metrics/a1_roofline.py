"""A1 (``kernels/attention.py``, ``csrc/chunked_attention.cu``) against its
roofline: the least time its forward and backward launches of the profiled
sub-window could take at the cell's shape (``counts.a1_bound_s``: flops
at the bf16 peak or bytes at the memory rate, whichever is larger, per
call), over the time its kernels took in the device trace, in %."""
from fpisa_bench import counts

SOURCE = "device_trace"
MOVES = "train_tok_s"


def _a1(name):
    return "attn_fwd" in name or "attn_bwd" in name


def read(r):
    p = r.profile
    if p is None:
        return None
    took = p.time_s(_a1)
    fwd = p.count(lambda n: _a1(n) and "attn_fwd" in n)
    bwd = p.count(lambda n: _a1(n) and "attn_bwd_dq" in n)
    if not took or not (fwd or bwd):
        return None
    c, t = r.cell.config, r.cell.traffic
    h = c["num_attention_heads"]
    bound = counts.a1_bound_s(t["batch"], t["seq"], h, c["hidden_size"] // h, 2, fwd, bwd)
    return 100 * bound / took
