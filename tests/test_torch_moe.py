"""The port's Mixture-of-Experts (repro_torch.models.moe and the moe family
of the model) against the JAX reference, at smoke size, on the same weights
and inputs (numpy seeds).

* ``apply_moe`` at several group sizes: output within 1e-5 of its largest
  |entry|, aux loss within 1e-5 relative, and the (group, expert, capacity)
  slot table equal to the reference's (caught where the reference passes
  it to ``hints.constrain``).
* F10, copied on purpose: an expert that receives more than ``capacity``
  (token, slot) pairs keeps ``capacity - 1`` tokens; the pair of rank
  ``capacity - 1`` gets zero. The set of tokens with an output, and the
  slot table, equal the reference's exactly.
* Top-k ties go to the lower expert index, as ``jax.lax.top_k``: exactly.
* Pad rows: a decode step of 20 rows computes 32 (two 16-row tiles), and
  only the 20 real rows enter the dispatch; prefill groups the whole
  batch's tokens as the reference does. With every token routed to one
  expert (so experts overflow), prefill, decode and paged decode logits
  equal the reference's within 2e-5.
* A train step whose batch is cut in two (``accum_steps``, logical workers)
  dispatches each half apart, as the reference's step: loss and grad norm
  within 2e-5.
* arctic (128 experts top-2 at full size, a parallel dense MLP) and kimi at
  smoke size: forward, loss (+ 0.01 aux) and gradients; prefill, decode and
  paged decode (the harness's tolerances, torch_model_parity.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro.models.layers import AxesRecorder  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from torch_model_parity import (check_forward_and_grads, check_paged_decode,  # noqa: E402
                                check_prefill_and_decode, make_batch, np_, pair)

ARCHS = ["arctic-480b", "kimi-k2-1t-a32b"]
TOL = 1e-5


def _params(cfg, seed):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), cfg, AxesRecorder(), "moe")
    return {k: np.asarray(v).copy() for k, v in jp.items()}


def _reference(monkeypatch, p, x, cfg):
    """The reference's apply_moe run eagerly: (out, aux, slot table)."""
    seen = {}
    real = jmoe.hints.constrain

    def spy(t, *placements):
        if placements == ("batch", "model", None) and jnp.issubdtype(t.dtype, jnp.integer):
            seen["slot_tok"] = np.asarray(t)
        return real(t, *placements)

    monkeypatch.setattr(jmoe.hints, "constrain", spy)
    out, aux = jmoe.apply_moe({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), cfg)
    return np.asarray(out), float(aux), seen["slot_tok"]


def _port(p, x, cfg):
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x)
    out, aux = tmoe.apply_moe(tp, tx, cfg)
    d = x.shape[-1]
    tg = tmoe.group_size(cfg, x.shape[0] * x.shape[1])
    r = tmoe.route(tp, tx.reshape(-1, tg, d), cfg)
    return np_(out), float(aux), r


@pytest.mark.parametrize("group", [64, 32, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_the_reference(monkeypatch, arch, group):
    cfg = get_smoke_config(arch).with_(moe_group_size=group)
    p = _params(cfg, 1)
    x = np.random.default_rng(2).standard_normal((4, 32, cfg.d_model)).astype(np.float32)
    want, want_aux, want_slots = _reference(monkeypatch, p, x, cfg)
    got, aux, r = _port(p, x, cfg)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
    np.testing.assert_allclose(aux, want_aux, rtol=TOL)
    np.testing.assert_array_equal(np_(r.slot_tok), want_slots)
    assert want_slots.shape[0] == 128 // group


def test_f10_an_overflowing_expert_keeps_capacity_minus_one(monkeypatch):
    """The probe: 4 experts, top-1, one group of 64 tokens (capacity 24); a
    router weight of 50 on feature 0, made positive for every token, sends
    all 64 to expert 0. Only tokens 0..22 get an output; token 23 (rank
    capacity - 1) gets zeros, as do 24..63 (dropped)."""
    cfg = get_smoke_config("arctic-480b").with_(num_experts=4, num_experts_per_token=1,
                                                moe_group_size=64)
    p = _params(cfg, 3)
    p["router"][:] = 0.0
    p["router"][0, 0] = 50.0
    x = np.random.default_rng(4).standard_normal((1, 64, cfg.d_model)).astype(np.float32)
    x[..., 0] = np.abs(x[..., 0]) + 1.0
    want, want_aux, want_slots = _reference(monkeypatch, p, x, cfg)
    got, aux, r = _port(p, x, cfg)
    cap = want_slots.shape[-1]
    assert cap == 24
    served = lambda out: np.flatnonzero(np.abs(out[0]).max(-1) > 0).tolist()  # noqa: E731
    assert served(want) == list(range(cap - 1))
    assert served(got) == served(want)
    np.testing.assert_array_equal(np_(r.slot_tok), want_slots)
    assert want_slots[0, 0, cap - 1] == 64                    # the sentinel
    assert bool(r.overflow[0, 0]) and int(r.overflow.sum()) == 1
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
    np.testing.assert_allclose(aux, want_aux, rtol=TOL)


def test_topk_ties_take_the_lower_index(monkeypatch):
    """A router whose experts 1 and 3 have equal logits, 0 and 2 zero: each
    token's top-2 is (1, 3) or (0, 2), lower index first, as the
    reference's; and a zero router (every expert tied) picks (0, 1)."""
    cfg = get_smoke_config("kimi-k2-1t-a32b").with_(num_experts=4, num_experts_per_token=2)
    x = np.random.default_rng(5).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    for case in ("pairs", "all"):
        p = _params(cfg, 6)
        v = p["router"][:, 1].copy()
        p["router"][:] = 0.0
        if case == "pairs":
            p["router"][:, 1] = p["router"][:, 3] = v
        want, want_aux, want_slots = _reference(monkeypatch, p, x, cfg)
        got, aux, r = _port(p, x, cfg)
        experts = np_(r.experts).reshape(-1, 2)
        if case == "pairs":
            up = (x.reshape(-1, cfg.d_model) @ v) > 0
            np.testing.assert_array_equal(experts, np.where(up[:, None], [1, 3], [0, 2]))
        else:
            np.testing.assert_array_equal(experts, np.broadcast_to([0, 1], experts.shape))
        np.testing.assert_array_equal(np_(r.slot_tok), want_slots)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
        np.testing.assert_allclose(aux, want_aux, rtol=TOL)


def _one_expert(params):
    """Every token to expert 0 in every layer (embedding feature 0 large,
    router column 0 on it): experts 0 and 1 (the tie-broken second choice)
    overflow."""
    params["embed"]["tok"][:, 0] = 10.0
    router = params["layers"]["moe"]["router"]
    router[:] = 0.0
    router[:, 0, 0] = 50.0


def test_pad_rows_stay_out_of_the_dispatch():
    """20 prompts of 8 tokens (the reference groups the 160 tokens by 32,
    capacity 24: experts 0 and 1 overflow), then 20-row decode steps
    (computed as 32 rows; the reference's group is the 20 real rows,
    capacity 16) and a 20-row paged decode step, against the reference."""
    jm, jp, pm = pair("arctic-480b", edit=_one_expert)
    tmoe.OVERFLOWS.read()
    batch = make_batch(pm.cfg, 20, 8, seed=9)
    check_prefill_and_decode(jm, jp, pm, batch, max_len=16, steps=2)
    assert tmoe.OVERFLOWS.read() > 0
    check_paged_decode(jm, jp, pm, b=20, seed=10, steps=1)
    assert tmoe.OVERFLOWS.read() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_model_matches_the_reference(arch):
    jm, jp, pm = pair(arch)
    check_forward_and_grads(jm, jp, pm, make_batch(pm.cfg, 2, 64, seed=11))
    check_prefill_and_decode(jm, jp, pm, make_batch(pm.cfg, 2, 64, seed=12), max_len=80)
    check_paged_decode(jm, jp, pm, b=3, seed=13)


@pytest.mark.parametrize("split", ["accum_steps", "logical_workers"])
def test_microbatch_splits_group_tokens_as_the_reference(split):
    """One FPISA train step with the batch cut in two (gradient
    accumulation, or two logical workers) on the every-token-to-one-expert
    weights: each half is its own dispatch (capacity 24 for 32 tokens, not
    40 for 64), as in the reference's step; loss and grad norm within 2e-5
    (``dp_boundary="replica"`` on both sides, so the reference aggregates
    over its data axis as the port does over its group)."""
    from repro.core.agg import AggConfig as JaxAggConfig
    from repro.optim import optimizers as jax_opt
    from repro.runtime.elastic import make_mesh_for
    from repro.train.step import make_train_step as jax_make_train_step
    from repro_torch.core.agg import AggConfig
    from repro_torch.optim import optimizers
    from repro_torch.train.step import make_train_step
    from torch_model_parity import jax_batch, torch_batch

    def loud(params):  # experts' outputs large enough for drops to move the loss
        _one_expert(params)
        params["layers"]["moe"]["wo"] *= 100.0

    jm, jp, pm = pair("arctic-480b", edit=loud, dp_boundary="replica")
    cfg = pm.cfg
    batch = make_batch(cfg, 4, 16, seed=14)
    kw = {split: 2}
    jopt = jax_opt.OptConfig(name=cfg.optimizer, lr=cfg.learning_rate)
    step = jax.jit(jax_make_train_step(jm, make_mesh_for(jax.devices()[:1]),
                                       JaxAggConfig(strategy="fpisa", backend="jnp"), jopt, 4,
                                       **kw))
    _, _, want = step(jp, jax_opt.init(jp, jopt), jax_batch(batch))
    whole = float(np_(pm.loss(torch_batch(batch))))
    opt_cfg = optimizers.OptConfig(name=cfg.optimizer, lr=cfg.learning_rate)
    tstep = make_train_step(pm, AggConfig(strategy="fpisa"), opt_cfg, 4, **kw)
    _, got = tstep(optimizers.init(list(pm.parameters()), opt_cfg), torch_batch(batch))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=2e-5)
    np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=2e-5)
    # the split changes the dispatch: the whole batch's loss is off by more
    # than 4x the tolerance
    assert abs(whole - float(want["loss"])) > 4 * 2e-5 * float(want["loss"])
