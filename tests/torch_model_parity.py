"""Shared harness of the model-family parity tests (``test_torch_models``,
``test_torch_moe``, ``test_torch_mamba2``, ``test_torch_encdec``): one
smoke config built on both sides from the SAME weights (the JAX init,
optionally edited, carried over with ``repro_torch.interop.params_from_jax``),
inputs from numpy seeds, and the checks every family shares.

Tolerances (float32 smoke configs; two frameworks differ in summation order
and transcendentals; both stream attention in the same (q, kv) chunks with
an online softmax):
* forward logits: 2e-5 of the largest |logit|; loss and aux: 2e-5
  relative; every gradient leaf: 2e-5 of that leaf's largest |entry|;
* prefill, decode and paged-decode logits: 2e-5 absolute; K/V and SSM /
  conv states: 1e-6 absolute.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models.registry import build as jax_build
from repro_torch.configs import get_smoke_config
from repro_torch.interop import params_from_jax
from repro_torch.models.registry import build

CPU = torch.device("cpu")
REL, LOGIT_ATOL, STATE_ATOL = 2e-5, 2e-5, 1e-6


def pair(arch: str, edit=None, **overrides):
    """(JAX model, JAX params, port model): the reference's init at
    PRNGKey(0), passed through ``edit(numpy tree)`` if given, on both.
    Without ``edit`` a pair is built once per process (the checks leave
    the weights as they are)."""
    if edit is None:
        return _pair(arch, tuple(sorted(overrides.items())))
    return _build_pair(arch, edit, overrides)


@functools.lru_cache(maxsize=None)
def _pair(arch, overrides):
    return _build_pair(arch, None, dict(overrides))


def _build_pair(arch, edit, overrides):
    jm = jax_build(jax_smoke(arch).with_(**overrides))
    init = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    if edit is not None:
        init = jax.tree.map(np.copy, init)
        edit(init)
    pm = build(get_smoke_config(arch).with_(**overrides), device=CPU,
               params=params_from_jax(init))
    return jm, jax.tree.map(jnp.asarray, init), pm


def make_batch(cfg, b: int, s: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (b, cfg.num_frames, cfg.d_model)).astype(np.float32)
    return batch


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def np_(t):
    return t.detach().cpu().numpy()


def check_forward_and_grads(jm, jp, pm, batch):
    """Logits, aux, loss and every gradient leaf within the stated
    tolerances; the gradient leaves in the reference's flatten order."""
    jl, jaux = jax.jit(jm.forward)(jp, jax_batch(batch))
    tl, taux = pm(torch_batch(batch))
    jl = np.asarray(jl)
    np.testing.assert_allclose(np_(tl), jl, rtol=0, atol=REL * np.abs(jl).max())
    np.testing.assert_allclose(float(np_(taux)), float(jaux), rtol=REL)
    jloss, jg = jax.jit(jax.value_and_grad(jm.loss))(jp, jax_batch(batch))
    loss = pm.loss(torch_batch(batch))
    np.testing.assert_allclose(float(np_(loss)), float(jloss), rtol=REL)
    names, params = zip(*pm.named_parameters())
    grads = torch.autograd.grad(loss, params)
    ref = jax.tree.leaves(jg)
    assert len(ref) == len(grads)
    for name, g, r in zip(names, grads, ref):
        r = np.asarray(r)
        assert g.shape == r.shape, name
        np.testing.assert_allclose(np_(g), r, rtol=0, atol=REL * np.abs(r).max(),
                                   err_msg=name)


def check_cache(pc, jc, rows: int):
    """The port cache's first ``rows`` rows against the reference's cache."""
    assert pc.pos == int(jc.pos)
    pairs = []
    if jc.kv is not None:
        pairs += [(pc.kv.k, jc.kv.k), (pc.kv.v, jc.kv.v)]
    if jc.ssm is not None:
        pairs += [(pc.ssm, jc.ssm), (pc.conv, jc.conv)]
    for mine, want in pairs:
        np.testing.assert_allclose(np_(mine[:, :rows]), np.asarray(want), rtol=0,
                                   atol=STATE_ATOL)


def check_prefill_and_decode(jm, jp, pm, batch, max_len: int, steps: int = 2, seed: int = 0):
    """Prefill, then ``steps`` decode steps on both sides: logits within
    2e-5, caches within 1e-6. Returns the port's cache."""
    b = batch["tokens"].shape[0]
    jl, jc = jax.jit(jm.prefill)(jp, jax_batch(batch), jm.init_cache(b, max_len))
    pl, pc = pm.prefill(torch.from_numpy(batch["tokens"]), pm.init_cache(b, max_len),
                        torch_batch(batch).get("patch_embeds"))
    np.testing.assert_allclose(np_(pl), np.asarray(jl), rtol=0, atol=LOGIT_ATOL)
    check_cache(pc, jc, b)
    rng = np.random.default_rng(seed)
    decode = jax.jit(jm.decode_step)
    for step in range(steps):
        nxt = rng.integers(0, pm.cfg.vocab_size, (b, 1)).astype(np.int32)
        jl, jc = decode(jp, jnp.asarray(nxt), jc)
        pl, pc = pm.decode_step(torch.from_numpy(nxt), pc)
        np.testing.assert_allclose(np_(pl), np.asarray(jl), rtol=0, atol=LOGIT_ATOL,
                                   err_msg=f"decode step {step}")
        check_cache(pc, jc, b)
    return pc


def check_paged_decode(jm, jp, pm, b: int, seed: int, steps: int = 2):
    """``decode_step_paged`` on both sides from the same pools, page table
    (slot 1 idle on the scratch page) and lengths: live rows' logits
    within 2e-5, live pages within 1e-6."""
    cfg = pm.cfg
    rng = np.random.default_rng(seed)
    page, mp = 8, 4
    shape = (cfg.num_layers, 1 + b * mp, page, cfg.num_kv_heads, cfg.resolved_head_dim)
    k_pool = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    v_pool = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    table = (1 + np.arange(b * mp, dtype=np.int32)[::-1]).reshape(b, mp).copy()
    table[1] = 0
    lens = rng.integers(1, page * mp - steps, b).astype(np.int32)
    lens[1] = 0
    live = [j for j in range(b) if j != 1]
    jk, jv = jnp.asarray(k_pool), jnp.asarray(v_pool)
    pk, pv = torch.from_numpy(k_pool.copy()), torch.from_numpy(v_pool.copy())
    paged = jax.jit(jm.decode_step_paged)
    for step in range(steps):
        nxt = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        jl, jk, jv = paged(jp, jnp.asarray(nxt), jk, jv, jnp.asarray(table), jnp.asarray(lens))
        pl, pk, pv = pm.decode_step_paged(torch.from_numpy(nxt), pk, pv,
                                          torch.from_numpy(table), torch.from_numpy(lens))
        np.testing.assert_allclose(np_(pl)[live], np.asarray(jl)[live], rtol=0,
                                   atol=LOGIT_ATOL, err_msg=f"paged step {step}")
        for mine, want in ((pk, jk), (pv, jv)):
            np.testing.assert_allclose(np_(mine)[:, 1:], np.asarray(want)[:, 1:], rtol=0,
                                       atol=STATE_ATOL)
        lens = lens + (np.arange(b) != 1).astype(np.int32)
