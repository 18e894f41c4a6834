"""The Zamba2 mamba blocks' time in a training step on the card: the
device intervals (``dev_dur``) of the program's ``zamba2.mamba_block``
spans (``models/zamba2.py``), summed over the steps the cell traces with
the program's global tracer (``repro_torch.trace.get()``) and divided by
those steps (the traffic's ``span_steps``), in ms. Under remat "full" a
block's span opens at its forward and again at its recompute in the
backward, so both are in. Nothing where the program has no such span or
it holds no device interval."""
SOURCE = "program_span"
MOVES = "train_tok_s"
SPAN = "zamba2.mamba_block"


def read(r):
    from repro_torch import trace

    durs = [s["dev_dur"] for s in trace.get().spans if s["name"] == SPAN and "dev_dur" in s]
    return 1e3 * sum(durs) / r.cell.traffic["span_steps"] if durs else None
