"""The card's idle share in training: the share of the profiled
sub-window (torch.profiler, the steps after the window) in which no device
operation ran, in %."""
SOURCE = "device_trace"
MOVES = "train_tok_s"


def read(r):
    p = r.profile
    return 100 * (1 - p.busy_s / p.window_s) if p is not None and p.window_s else None
