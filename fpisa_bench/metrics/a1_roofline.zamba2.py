"""A1 at the Zamba2 shared blocks' head_dim (``attention_head_dim``, 224)
against its roofline: the least time the profiled sub-window's forward and
backward launches could take (``counts.a1_bound_s`` at the cell's batch,
sequence, heads and head_dim, bf16), over the time A1's kernels took in the
device trace, in %. Backward calls are counted by their ``attn_bwd_dq``
kernel."""
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
    fwd = p.count(lambda n: "attn_fwd" in n)
    bwd = p.count(lambda n: "attn_bwd_dq" in n)
    if not took or not (fwd or bwd):
        return None
    c, t = r.cell.config, r.cell.traffic
    bound = counts.a1_bound_s(t["batch"], t["seq"], c["num_attention_heads"],
                              c["attention_head_dim"], 2, fwd, bwd)
    return 100 * bound / took
