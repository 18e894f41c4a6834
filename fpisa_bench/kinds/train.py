"""Training cells: the program's train step (``repro_torch.train.step.
make_train_step`` on a world of one: ``model.loss`` and its gradients, the
``Aggregator``'s ``allreduce_tree``, the optimizer's update), driven closed
loop, one step after another, on seeded token batches.

Set-up makes the weights from the seed on the card, builds the model, the
step and the optimizer state, and drives that same step through the
cell's first ``check_steps`` steps (which also warm every shape), reading
the losses, the first aggregated gradient (from the optimizer's first
moment) and the parameters' change. The window continues the same step on
the next batches. After it, with the program's state freed, the plain
reference (``reference_train.follow``) trains from the same weights on the
same first batches, and the readings are compared.

Traffic keys: ``batch``, ``seq``, ``agg`` (``AggConfig`` fields),
``optimizer`` (AdamW's settings), ``pool`` (distinct batches the window
cycles through), ``check_steps``, ``profile_steps``, ``span_steps``.
"""
from __future__ import annotations

import statistics
import time

import torch

from fpisa_bench import common, data, reference_train, spec

AGG_SPAN = "agg.allreduce_tree"


def program_config(cfg: dict):
    """The program's ``ModelConfig`` for a configuration file: its
    published sizes, and the program's own settings under ``program``."""
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(
        name=cfg["name"], num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"], num_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        rope_theta=cfg["rope_theta"], norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"], **cfg["program"])


def batches(cfg: dict, traffic: dict, seed: int, count: int, device) -> torch.Tensor:
    """(count, batch, seq) token ids of steps 0 .. count - 1."""
    return torch.stack([torch.from_numpy(data.token_batch(
        cfg["vocab_size"], seed, i, traffic["batch"], traffic["seq"])) for i in range(count)]
    ).to(device=device, dtype=torch.int64)


STILL = 1e-3  # a leaf under this share of the median leaf's gradient moves by round-off


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared: ``loss_gap``, the largest relative gap of a
    step's loss; ``grad_gap``, of a leaf's first-gradient norm; and
    ``change_gap``, of a leaf's parameter-change norm. A gap of norms is
    taken against the reference's norm of that leaf or of the median leaf,
    whichever is larger. Leaves whose first aggregated gradient in the
    reference is under ``STILL`` x the median leaf's (zero but for rounding,
    as a key bias under softmax) move by round-off alone and are left out of
    the change."""
    def gap(a, b, floor):
        d = abs(a - b) / max(abs(b), floor)
        return d if d == d else float("inf")  # NaN reads as failed

    loss_gap = max(gap(a, b, 0.0) for a, b in zip(prog["losses"], ref["losses"]))
    med_g = statistics.median(ref["grad"].values())
    grad_gap = max(gap(prog["grad"][n], ref["grad"][n], med_g) for n in ref["grad"])
    med_a = statistics.median(ref["agg_grad"].values())
    moving = [n for n in ref["change"] if ref["agg_grad"][n] >= STILL * med_a]
    med_c = statistics.median(ref["change"][n] for n in moving)
    change_gap = max(gap(prog["change"][n], ref["change"][n], med_c) for n in moving)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


def run(r: common.Run, limits: dict) -> None:
    from repro_torch import trace as ptrace
    from repro_torch.core import agg as agg_mod
    from repro_torch.models import registry
    from repro_torch.models.layers import dtype_of
    from repro_torch.optim import optimizers
    from repro_torch.train.step import make_train_step

    cfg, tr, dev = r.cell.config, r.cell.traffic, r.device
    ref_model = spec.reference(r.cell.config_name)
    mc = program_config(cfg)
    pspec = ref_model.param_spec(cfg)
    pdtype = dtype_of(mc.param_dtype)
    r.mark("imports")
    model = registry.build(mc, device=dev, params=common.nest(
        common.make_weights(pspec, r.seed, dev, pdtype)))
    names, params = zip(*model.named_parameters())
    want = [(n, tuple(s)) for n, s, _ in pspec]
    if [(n, tuple(p.shape)) for n, p in zip(names, params)] != want:
        raise RuntimeError(f"the program's leaves differ from the reference's: {names}")
    opt_cfg = optimizers.OptConfig(name="adamw", **tr["optimizer"])
    step = make_train_step(model, agg_mod.AggConfig(**tr["agg"]), opt_cfg, tr["batch"])
    state = optimizers.init(params, opt_cfg)
    pool = batches(cfg, tr, r.seed, tr["pool"], dev)
    tokens = tr["batch"] * tr["seq"]
    r.mark("weights, model, step, batches")

    # the checked steps: the window's own call and feed, which warm every shape
    start = [p.detach().clone() for p in params]
    losses = []
    for i in range(tr["check_steps"]):
        state, met = step(state, {"tokens": pool[i]})
        losses.append(met["loss"])
        if i == 0:
            grad = {n: float(m.norm()) / (1 - opt_cfg.b1) for n, m in zip(names, state.m)}
    prog = {"losses": [float(x) for x in losses], "grad": grad,
            "change": {n: float((p.detach().float() - s.float()).norm())
                       for n, p, s in zip(names, params, start)}}
    del start, losses
    r.mark_setup_done()

    held = {"state": state, "losses": []}

    def one(i):
        batch = {"tokens": pool[(tr["check_steps"] + i) % len(pool)]}
        held["state"], met = step(held["state"], batch)
        held["losses"].append(met["loss"])

    r.window = common.timed_window(one, r.seconds, dev, tokens)
    r.mark_window_done()
    r.attempted = r.window.count
    r.failed = sum(1 for x in held["losses"] if not torch.isfinite(x))
    if r.trace and dev.type == "cuda":
        n = tr["profile_steps"]
        r.profile = common.profile(lambda: [one(i) for i in range(n)], n, dev)
        r.host_profile = common.profile(lambda: one(0), 1, dev, host="train step")
        r.spans = _agg_spans(one, tr["span_steps"], dev, ptrace, agg_mod)
    r.mark_traced_done()
    del model, params, step, state, held, pool, one
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ref = reference_train.follow(
        ref_model, cfg, common.make_weights(pspec, r.seed, dev, pdtype),
        list(batches(cfg, tr, r.seed, tr["check_steps"], dev)), tr["optimizer"], pdtype)
    r.readings = {"program": prog, "reference": ref, "reference_s": time.perf_counter() - t0}
    r.checks = {k: (v, limits[k]) for k, v in compare(prog, ref).items()}


def _agg_spans(one, steps: int, dev, ptrace, agg_mod) -> list:
    """The program's ``agg.allreduce_tree`` spans over ``steps`` steps, with
    the device synchronized as the aggregation starts, so that each span
    holds the aggregation's work alone (the span itself synchronizes as it
    ends)."""
    plain = agg_mod.Aggregator.allreduce_tree

    def synced(self, tree):
        common.sync(dev)
        return plain(self, tree)

    agg_mod.Aggregator.allreduce_tree = synced
    tracer = ptrace.enable()
    try:
        for i in range(steps):
            one(i)
        common.sync(dev)
    finally:
        ptrace.disable()
        agg_mod.Aggregator.allreduce_tree = plain
    return [s for s in tracer.spans if s["name"] == AGG_SPAN]
