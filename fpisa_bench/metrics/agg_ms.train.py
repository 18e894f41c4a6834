"""The aggregation's time in a training step: the program's
``agg.allreduce_tree`` span (``core/agg.py``), which synchronizes on its
output, in steps where the harness synchronizes the card just before the
aggregation starts; the mean over those steps, in ms."""
SOURCE = "program_span"
MOVES = "train_tok_s"


def read(r):
    spans = [s["dur"] for s in r.spans if s["name"] == "agg.allreduce_tree"]
    return 1e3 * sum(spans) / len(spans) if spans else None
