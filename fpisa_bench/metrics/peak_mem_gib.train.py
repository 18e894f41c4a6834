"""The training window's peak of allocated device memory
(``torch.cuda.max_memory_allocated`` from the window's start to its end),
in GiB."""
SOURCE = "program_counter"
MOVES = "train_tok_s"


def read(r):
    return r.window_peak_bytes / 2**30 if r.window_peak_bytes else None
