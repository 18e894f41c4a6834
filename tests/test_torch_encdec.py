"""The port's encoder-decoder (``repro_torch.models.encdec``, whisper-medium)
against the JAX reference (``repro.models.encdec``), at smoke size (2
encoder and 2 decoder layers, d_model 64, 24 frames), both sides starting
from the SAME weights (the JAX init carried over with
``repro_torch.interop.params_from_jax``); inputs from numpy seeds.
Tolerances are the shared harness's (``torch_model_parity``): logits, loss
and every gradient leaf 2e-5 (relative to the largest |entry| where the
harness says so); K/V 1e-6 absolute.

* ``encode``; the bidirectional ``attention_train`` (output and the
  weights' gradients), ``encode_cross_kv`` and ``cross_attention``.
* Forward logits, loss and every gradient leaf at 64 decoder tokens (two of
  the reference's 32-token attention chunks).
* Prefill (last-position logits, self and cross K/V), 4 decode steps
  (logits and self K/V), and decode against a forward over the extended
  tokens.
* remat "full" == "dots" == "none" bit for bit ("dots" runs as "full",
  as the reference's ``encdec._remat`` runs it).
* The weights round trip in the reference's layout and flatten order.
* ``global_batch_at`` adds seeded frames, and ``split_batch`` cuts them
  with the tokens (``accum_steps`` and logical workers).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.interop import params_to_jax  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from torch_model_parity import (LOGIT_ATOL, REL, STATE_ATOL, check_forward_and_grads,  # noqa: E402
                                jax_batch, make_batch, np_, pair, torch_batch)

ARCH = "whisper-medium"
CPU = torch.device("cpu")


def _close(mine, want, rel=None, atol=None, what=""):
    want = np.asarray(want)
    if rel is not None:
        atol = rel * np.abs(want).max()
    np.testing.assert_allclose(np_(mine) if torch.is_tensor(mine) else mine, want, rtol=0,
                               atol=atol, err_msg=what)


def test_encode_matches_the_reference():
    jm, jp, pm = pair(ARCH)
    frames = make_batch(pm.cfg, 2, 8, seed=11)["frames"]
    want = jax.jit(lambda p, f: jencdec.encode(p, f, jm.cfg))(jp, jnp.asarray(frames))
    with torch.no_grad():
        got = pm.encode(torch.from_numpy(frames))
    _close(got, want, rel=REL)


def test_attention_pieces_match_the_reference():
    """One encoder layer's bidirectional self-attention (RoPE over the frame
    positions) and its weights' gradients of a fixed projection; one
    decoder layer's ``encode_cross_kv`` (1e-6) and ``cross_attention`` over
    them at 32 decoder positions."""
    jm, jp, pm = pair(ARCH)
    cfg = pm.cfg
    rng = np.random.default_rng(12)
    f, s = cfg.num_frames, 32
    x = rng.standard_normal((2, f, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((2, f, cfg.d_model)).astype(np.float32)
    jlp = jax.tree.map(lambda a: a[0], jp["enc_layers"]["attn"])
    pos = jnp.broadcast_to(jnp.arange(f), (2, f))

    def jloss(p):
        out = jattn.attention_train(p, jnp.asarray(x), cfg, pos, causal=False)
        return jnp.sum(out * r), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jlp)
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in jlp.items()}
    out = tattn.attention_train(tp, torch.from_numpy(x), cfg, torch.arange(f), causal=False)
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum(), list(tp.values()))
    _close(out, jout, rel=REL, what="bidirectional attention")
    for k, g in zip(tp, grads):
        _close(g, jg[k], rel=REL, what=k)

    xp = {k: np.array(v[0]) for k, v in jp["dec_layers"]["xattn"].items()}
    tx = {k: torch.from_numpy(v) for k, v in xp.items()}
    jkv = jattn.encode_cross_kv(xp, jnp.asarray(x))
    tkv = tattn.encode_cross_kv(tx, torch.from_numpy(x))
    for mine, want in zip(tkv, jkv):
        _close(mine, want, atol=STATE_ATOL, what="cross K/V")
    y = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, y, kv: jattn.cross_attention(p, y, kv, cfg))(xp, jnp.asarray(y), jkv)
    got = tattn.cross_attention(tx, torch.from_numpy(y), tkv, cfg)
    _close(got, want, rel=REL, what="cross attention")


def test_forward_loss_and_gradients_match_the_reference():
    jm, jp, pm = pair(ARCH)
    check_forward_and_grads(jm, jp, pm, make_batch(pm.cfg, 2, 64, seed=13))


def _check_cache(pc, jc, b):
    assert pc.pos == int(jc.pos)
    pairs = [(pc.self_kv.k, jc.self_kv.k), (pc.self_kv.v, jc.self_kv.v),
             (pc.cross_kv[0], jc.cross_kv[0]), (pc.cross_kv[1], jc.cross_kv[1])]
    for mine, want in pairs:
        _close(mine[:, :b], want, atol=STATE_ATOL)


def test_prefill_and_decode_match_the_reference():
    """Prefill of 16-token prompts over 24 frames (last-position logits,
    self and cross K/V), then 4 decode steps (logits, every cache)."""
    jm, jp, pm = pair(ARCH)
    b, max_len = 2, 32
    batch = make_batch(pm.cfg, b, 16, seed=14)
    jl, jc = jax.jit(jm.prefill)(jp, jax_batch(batch), jm.init_cache(b, max_len))
    tb = torch_batch(batch)
    pl, pc = pm.prefill(tb["tokens"], pm.init_cache(b, max_len), tb["frames"])
    _close(pl, jl, atol=LOGIT_ATOL, what="prefill")
    _check_cache(pc, jc, b)
    rng = np.random.default_rng(15)
    decode = jax.jit(jm.decode_step)
    for step in range(4):
        nxt = rng.integers(0, pm.cfg.vocab_size, (b, 1)).astype(np.int32)
        jl, jc = decode(jp, jnp.asarray(nxt), jc)
        pl, pc = pm.decode_step(torch.from_numpy(nxt), pc)
        _close(pl, jl, atol=LOGIT_ATOL, what=f"decode step {step}")
        _check_cache(pc, jc, b)


def test_decode_matches_a_forward_over_the_extended_tokens():
    """The reference's own serving check (``tests/test_models.py``):
    prefill's logits are the forward's last position, and each of 4 decode
    steps' logits are a fresh forward's over the extended tokens at that
    position (2e-5 of the largest |logit|)."""
    _, _, pm = pair(ARCH)
    batch = torch_batch(make_batch(pm.cfg, 2, 8, seed=16))
    tokens = batch["tokens"]
    logits, cache = pm.prefill(tokens, pm.init_cache(2, 16), batch["frames"])
    for step in range(5):
        if step:
            nxt = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            logits, cache = pm.decode_step(nxt, cache)
            tokens = torch.cat([tokens, nxt], dim=1)
        with torch.no_grad():
            full, _ = pm({"frames": batch["frames"], "tokens": tokens})
        _close(logits[:, -1], np_(full[:, -1]), rel=REL, what=f"step {step}")


def test_remat_full_and_none_give_the_same_bits():
    cfg = get_smoke_config(ARCH)
    batch = torch_batch(make_batch(cfg, 2, 32, seed=17))
    runs = []
    for remat in ("full", "none", "dots"):
        model = build(cfg.with_(remat=remat), device=CPU, seed=0)
        loss = model.loss(batch)
        runs.append([loss] + list(torch.autograd.grad(loss, list(model.parameters()))))
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)


def test_weights_carry_across_in_the_reference_layout():
    """params_from_jax / params_to_jax keep the 26 leaves, their bits and
    the reference's flatten order, in a bf16 model too."""
    for kw in ({}, {"param_dtype": "bfloat16", "activation_dtype": "bfloat16"}):
        _, jp, pm = pair(ARCH, **kw)
        ref = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
        back = params_to_jax(pm)
        assert jax.tree.structure(back) == jax.tree.structure(ref)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(a, b)
        paths = ["/".join(k.key for k in path)
                 for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
        assert [n.replace(".", "/") for n, _ in pm.named_parameters()] == paths
        assert len(paths) == 26
        want = torch.bfloat16 if kw else torch.float32
        assert all(p.dtype == want for p in pm.parameters())


def test_frames_travel_with_the_batch():
    """``global_batch_at`` adds seeded float32 frames (the same for the
    same (seed, step), another for another step); a step with
    ``accum_steps=2`` and one with 2 logical workers report the loss of the
    whole batch (1e-6 relative), so ``split_batch`` cut the frames with
    their tokens."""
    from repro_torch.core.agg import AggConfig
    from repro_torch.data.pipeline import ShardedLoader, SyntheticCorpus
    from repro_torch.launch.train import global_batch_at
    from repro_torch.optim import optimizers
    from repro_torch.train.step import make_train_step, split_batch

    cfg = get_smoke_config(ARCH)
    loader = ShardedLoader(SyntheticCorpus(cfg.vocab_size, 0), 4, 16)
    batch = global_batch_at(cfg, loader, 0, 1)
    assert batch["frames"].shape == (4, cfg.num_frames, cfg.d_model)
    assert batch["frames"].dtype == np.float32
    np.testing.assert_array_equal(global_batch_at(cfg, loader, 0, 1)["frames"], batch["frames"])
    assert not np.array_equal(global_batch_at(cfg, loader, 0, 2)["frames"], batch["frames"])
    tb = torch_batch(batch)
    for i, part in enumerate(split_batch(tb, 2)):
        for k in tb:
            assert torch.equal(part[k], tb[k][2 * i:2 * i + 2]), k
    with torch.no_grad():
        want = float(build(cfg, device=CPU, seed=0).loss(tb))
    opt_cfg = optimizers.OptConfig(name=cfg.optimizer, lr=cfg.learning_rate)
    for kw in ({"accum_steps": 2}, {"logical_workers": 2}):
        model = build(cfg, device=CPU, seed=0)
        step = make_train_step(model, AggConfig(strategy="fpisa"), opt_cfg, 4, **kw)
        _, metrics = step(optimizers.init(list(model.parameters()), opt_cfg), tb)
        np.testing.assert_allclose(float(metrics["loss"]), want, rtol=1e-6, err_msg=str(kw))
