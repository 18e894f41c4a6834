"""The port's decoder-only model families against the JAX reference, at
smoke size, both sides starting from the SAME weights (the JAX init carried
over with repro_torch.interop.params_from_jax); inputs from numpy seeds.
The MoE and SSM specifics live in test_torch_moe.py / test_torch_mamba2.py;
the shared harness and its tolerances in torch_model_parity.py (logits,
loss and every gradient leaf 2e-5 relative; serving logits 2e-5, caches
1e-6).

* Every config (CONFIG and SMOKE), whisper-medium's too, is a
  field-for-field copy of the reference's; none raises NotPortedError.
* The dense configs and the vlm (patch prefix) at seq 64, two attention
  chunks of the reference's ``attn_q_chunk=32``: forward, loss and
  gradients; prefill, decode and paged decode.
* GQA at every ratio the configs use (g = 4 in the smoke models; 6, 7, 8
  on one attention layer), training, prefill, decode and paged decode.
* ``remat``: "full" (checkpointed layer bodies) and "none" give the same
  bits; "dots" raises.
* The weights of every family carry across in the reference's layout, the
  float32 leaves of a bf16 model in float32.
* One FPISA aggregation per family over 2 gloo ranks, fed the same
  per-worker gradients: bit-exact with the reference's aggregation.
* ``launch.train`` trains every config, whisper-medium too (its
  encoder-decoder is held to the reference in test_torch_encdec.py), and
  ``launch.serve`` serves every decoder-only config; both engines refuse
  the encoder-decoder.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro_torch import NotPortedError  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import base as torch_base  # noqa: E402
from repro_torch.interop import params_to_jax  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from torch_model_parity import (check_forward_and_grads, check_paged_decode,  # noqa: E402
                                check_prefill_and_decode, make_batch, pair, torch_batch)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = jax_configs.ARCH_NAMES
DECODER_ARCHS = [a for a in ARCHS if a != "whisper-medium"]
DENSE_VLM = ["qwen1.5-0.5b", "internlm2-20b", "deepseek-67b", "stablelm-3b", "llava-next-34b"]
# one arch per family for the layout and aggregation checks
FAMILY_ARCH = {"dense": "internlm2-20b", "moe": "arctic-480b", "ssm": "mamba2-780m",
               "hybrid": "zamba2-7b", "vlm": "llava-next-34b"}


def test_configs_copy_the_reference():
    assert configs.ARCH_NAMES == ARCHS
    assert configs.NOT_PORTED == ()
    for arch in ARCHS:
        for mine, ref in ((configs.get_config(arch), jax_configs.get_config(arch)),
                          (configs.get_smoke_config(arch), jax_configs.get_smoke_config(arch))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref), arch
    assert configs.get_config("whisper-medium").is_encoder_decoder
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")
    from repro.configs import base as jax_base

    mine = [(f.name, f.default) for f in dataclasses.fields(torch_base.ModelConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(jax_base.ModelConfig)]
    assert mine == ref


def test_list_configs_and_the_shape_names_match_the_reference():
    mine, ref = configs.list_configs(), jax_configs.list_configs()
    assert list(mine) == list(ref) == ARCHS
    for arch in ARCHS:
        assert dataclasses.asdict(mine[arch]) == dataclasses.asdict(ref[arch]), arch
    assert (configs.SHAPES, configs.ShapeConfig, configs.shape_applicable) == (
        torch_base.SHAPES, torch_base.ShapeConfig, torch_base.shape_applicable)
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jax_configs.SHAPES.items()}
    assert [configs.shape_applicable(mine[a], s) for a in ARCHS
            for s in configs.SHAPES.values()] == \
        [jax_configs.shape_applicable(ref[a], s) for a in ARCHS
         for s in jax_configs.SHAPES.values()]


@pytest.mark.parametrize("arch", DENSE_VLM)
def test_forward_loss_and_gradients_match_the_reference(arch):
    jm, jp, pm = pair(arch)
    check_forward_and_grads(jm, jp, pm, make_batch(pm.cfg, 2, 64, seed=1))


@pytest.mark.parametrize("arch", DENSE_VLM)
def test_serving_matches_the_reference(arch):
    """Prefill of 64-token prompts (after the vlm's patch prefix), two
    decode steps and two paged decode steps."""
    jm, jp, pm = pair(arch)
    check_prefill_and_decode(jm, jp, pm, make_batch(pm.cfg, 2, 64, seed=2), max_len=96)
    check_paged_decode(jm, jp, pm, b=3, seed=3)


@pytest.mark.parametrize("g", [6, 7, 8])
def test_gqa_every_ratio(g):
    """One attention layer at num_heads / num_kv_heads = g (internlm2 6 at
    full size, arctic and llava 7, kimi and deepseek 8; g = 4, internlm2's
    and deepseek's smoke configs, runs through the whole-model checks),
    head_dim 8, seq 64 (two of the reference's 32-token chunks), against
    the reference's functions on the same weights: training (output and the
    weights' gradients of a fixed projection), prefill (output and the K/V
    it writes), decode at position 64, and paged decode over the same
    values in pages of 8 (tolerances of the model checks)."""
    from repro.models import attention as jattn
    from repro.models.layers import AxesRecorder
    from repro_torch.models import attention as tattn

    cfg = configs.get_smoke_config("internlm2-20b").with_(
        num_heads=2 * g, num_kv_heads=2, d_model=16 * g)
    rng = np.random.default_rng(g)
    jp = jattn.init_attention(jax.random.PRNGKey(g), cfg, AxesRecorder(), "attn")
    tp = {k: torch.from_numpy(np.asarray(v)).requires_grad_() for k, v in jp.items()}
    x = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(64), (2, 64))

    def jloss(p):
        out = jattn.attention_train(p, jnp.asarray(x), cfg, pos)
        return jnp.sum(out * r), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    out = tattn.attention_train(tp, torch.from_numpy(x), cfg, torch.arange(64))
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum(), list(tp.values()))
    atol = 2e-5 * np.abs(np.asarray(jout)).max()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=atol)
    for k, gr in zip(tp, grads):
        want = np.asarray(jg[k])
        np.testing.assert_allclose(gr.numpy(), want, rtol=0, atol=2e-5 * np.abs(want).max(),
                                   err_msg=k)

    tp = {k: v.detach() for k, v in tp.items()}
    jc = jattn.init_kv_cache(2, 72, cfg, jnp.float32)
    jout, jc = jax.jit(lambda c: jattn.attention_prefill(jp, jnp.asarray(x), cfg, pos, c))(jc)
    tc = tattn.init_kv_cache(2, 72, cfg, torch.float32, torch.device("cpu"))
    out, tc = tattn.attention_prefill(tp, torch.from_numpy(x), cfg, torch.arange(64), tc)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=2e-5)
    for mine, want in zip(tc, jc):
        np.testing.assert_allclose(mine.numpy(), np.asarray(want), rtol=0, atol=1e-6)

    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jout, jc = jax.jit(lambda c: jattn.attention_decode(jp, jnp.asarray(x1), cfg, c, 64))(jc)
    out, tc = tattn.attention_decode(tp, torch.from_numpy(x1), cfg, tc, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=2e-5)
    for mine, want in zip(tc, jc):
        np.testing.assert_allclose(mine.numpy(), np.asarray(want), rtol=0, atol=1e-6)

    # the same cache as 9 pages of 8 per row (slot j owns pages 1 + 9j ..)
    pools = [np.concatenate([np.zeros((1, 8, 2, 8), np.float32),
                             np.asarray(c).reshape(18, 8, 2, 8)]) for c in jc]
    table = np.arange(1, 19, dtype=np.int32).reshape(2, 9)
    lens = np.array([65, 65], np.int32)
    jout, jk, jv = jax.jit(lambda k, v: jattn.attention_decode_paged(
        jp, jnp.asarray(x1), cfg, k, v, jnp.asarray(table), jnp.asarray(lens)))(*pools)
    out, tk, tv = tattn.attention_decode_paged(
        tp, torch.from_numpy(x1), cfg, *(torch.from_numpy(q.copy()) for q in pools),
        torch.from_numpy(table), torch.from_numpy(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=2e-5)
    for mine, want in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_remat_full_and_none_give_the_same_bits():
    """``remat="full"`` recomputes each layer in the backward and ``"none"``
    keeps the activations: same loss and gradients bit for bit, on every
    family's layer loop. ``flash_remat`` (each step of the chunked attention
    checkpointed) and ``seq_parallel`` change only memory and sharding, so
    they change no value either. ``attn_q_chunk`` sets the chunks of the
    online softmax and so the order of its float32 additions (as in the
    reference): 8 instead of 32 gives the loss within 2e-5 relative and
    every gradient within 2e-5 of its leaf's largest |entry| (the parity
    harness's tolerances). ``"dots"`` (no config uses it) raises
    NotPortedError."""
    from repro_torch.models.registry import build

    for arch in FAMILY_ARCH.values():
        cfg = configs.get_smoke_config(arch)
        batch = torch_batch(make_batch(cfg, 2, 32, seed=7))
        runs = []
        for kw in ({"remat": "full"}, {"remat": "none"},
                   {"flash_remat": not cfg.flash_remat, "seq_parallel": True},
                   {"attn_q_chunk": 8}):
            model = build(cfg.with_(**kw), device=torch.device("cpu"), seed=0)
            loss = model.loss(batch)
            runs.append([loss] + list(torch.autograd.grad(loss, list(model.parameters()))))
        for other in runs[1:-1]:
            for a, b in zip(runs[0], other):
                assert torch.equal(a, b), arch
        for a, b in zip(runs[0], runs[-1]):
            a, b = a.detach(), b.detach()
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                       atol=2e-5 * float(a.abs().max()), err_msg=arch)
    with pytest.raises(NotPortedError, match="dots"):
        build(configs.get_smoke_config("qwen1.5-0.5b").with_(remat="dots"),
              device=torch.device("cpu"))


@pytest.mark.parametrize("family", [f for f in FAMILY_ARCH if f != "ssm"])
def test_attn_q_chunk_8_matches_the_reference(family):
    """At ``attn_q_chunk=8`` (four q-chunks and four kv-chunks at S = 32:
    the chunking that test_remat_full_and_none_give_the_same_bits holds
    within 2e-5 of chunk 32) the port's forward, loss and every gradient
    leaf agree with the reference's at the same chunk, within the parity
    harness's tolerances. The ssm family has no attention."""
    jm, jp, pm = pair(FAMILY_ARCH[family], attn_q_chunk=8)
    check_forward_and_grads(jm, jp, pm, make_batch(pm.cfg, 2, 32, seed=7))


@pytest.mark.parametrize("family", list(FAMILY_ARCH))
def test_weights_carry_across_in_the_reference_layout(family):
    """params_from_jax / params_to_jax keep every leaf, its bits and the
    reference's flatten order, also in a bf16 model whose SSM ``a_log``,
    ``d_skip``, ``dt_bias`` and MoE ``router`` stay float32."""
    arch = FAMILY_ARCH[family]
    jm, jp, pm = pair(arch, param_dtype="bfloat16", activation_dtype="bfloat16")
    ref = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    back = params_to_jax(pm)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
    paths = ["/".join(k.key for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [n.replace(".", "/") for n, _ in pm.named_parameters()] == paths
    for (name, p), r in zip(pm.named_parameters(), jax.tree.leaves(jp)):
        want = torch.float32 if r.dtype == np.float32 else torch.bfloat16
        assert p.dtype == want, name
        if name.rsplit(".", 1)[-1] in ("a_log", "d_skip", "dt_bias", "router"):
            assert p.dtype == torch.float32, name


# ---------------------------------------------------------------------------
# the launchers, every config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_every_config(arch, capsys):
    train_cli.main(["--device", "cpu", "--arch", arch, "--smoke", "--steps", "2",
                    "--global-batch", "2", "--seq-len", "32", "--agg", "fpisa"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("[train] step")]
    assert len(lines) == 2, out
    assert all(np.isfinite(float(ln.split()[4])) for ln in lines)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_serves_every_config(arch, capsys):
    """The continuous engine for the attention families; ssm and hybrid
    refuse it (the reference's error) and serve through the static
    engine. The encoder-decoder needs audio frames at prefill: the CLI
    refuses it as a usage error with either engine, and both engines
    refuse its model."""
    cfg = configs.get_smoke_config(arch)
    family = cfg.family
    argv = ["--device", "cpu", "--smoke", "--arch", arch, "--requests", "3"]
    if cfg.is_encoder_decoder:
        from repro_torch.models.registry import build
        from repro_torch.serve.engine import ServeEngine
        from repro_torch.serve.scheduler import ContinuousEngine

        refusal = "is an encoder-decoder whose prefill needs audio frames"
        for engine in ("static", "continuous"):
            with pytest.raises(SystemExit) as exc:
                serve_cli.main(argv + ["--engine", engine])
            assert exc.value.code == 2
            assert refusal in capsys.readouterr().err
        model = build(cfg, device=torch.device("cpu"))
        with pytest.raises(ValueError, match=refusal):
            ServeEngine(model, batch_size=2, max_len=16)
        with pytest.raises(ValueError, match=refusal):
            ContinuousEngine(model, num_slots=2, max_len=16, page_size=8)
        return
    if family in ("ssm", "hybrid"):
        with pytest.raises(ValueError, match="has no paged decode path"):
            serve_cli.main(argv + ["--engine", "continuous"])
        serve_cli.main(argv + ["--engine", "static"])
    else:
        serve_cli.main(argv + ["--engine", "continuous"])
    out = capsys.readouterr().out
    assert "'requests': 3" in out, out
