"""The optimizer's time in a training step on the card: the device
interval (``dev_dur``) of the program's ``train.optimizer`` span
(``train/step.py``: ``optimizers.update``, clipping included), from the
phase's first queued work to its last, idle included, in the steps the
cell traces with the program's global tracer (``repro_torch.trace.get()``);
the mean over those steps, in ms. Nothing where the program has no such
span or it holds no device interval."""
SOURCE = "program_span"
MOVES = "train_tok_s"
SPAN = "train.optimizer"


def read(r):
    from repro_torch import trace

    durs = [s["dev_dur"] for s in trace.get().spans if s["name"] == SPAN and "dev_dur" in s]
    return 1e3 * sum(durs) / len(durs) if durs else None
