"""The port's zamba2 family (``models/zamba2.py``, config
``zamba2-7b-published``) on the CPU, against the plain float32 reference
``tests/zamba2_plain.py`` (plain torch, independent of the port).

At the SMOKE size (2 shared blocks over 3 applications at the irregular
layers 1, 2, 4; 2 B/C groups; head_dim = 2 d / heads and the (hd / 2)^-0.5
scale; several SSD chunks and two attention chunks a sequence) on seeded
float32 weights, the loss and every leaf's gradient match the reference:
the loss within 2e-5 relative, each gradient within 2e-5 of its leaf's
largest |entry|, the parity harness's tolerances (``torch_model_parity``):
float32 on both sides, which differ only in the order of float32 additions
(the SSD's chunks all at once against one after another, the online
softmax over two key chunks against one softmax, the norms' sums). A
planted change to the model (the shared block's output kept in the
residual, the adapters dropped) fails the same comparison.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import pytest
import torch

import zamba2_plain
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import registry, zamba2

ROOT = Path(__file__).resolve().parents[1]
ARCH = "zamba2-7b-published"
REL = 2e-5


def plain_cfg(mc) -> dict:
    """The published configuration's keys, as the reference reads them,
    for a port ``ModelConfig``."""
    return {"hidden_size": mc.d_model, "num_attention_heads": mc.num_heads,
            "attention_head_dim": mc.resolved_head_dim, "ffn_hidden_size": mc.d_ff,
            "vocab_size": mc.vocab_size, "num_hidden_layers": mc.num_layers,
            "hybrid_layer_ids": list(mc.hybrid_layer_ids), "num_mem_blocks": mc.num_mem_blocks,
            "adapter_rank": mc.adapter_rank, "mamba_expand": mc.ssm_expand,
            "mamba_headdim": mc.ssm_head_dim, "mamba_ngroups": mc.ssm_groups,
            "mamba_d_state": mc.ssm_state, "mamba_d_conv": mc.ssm_conv_width,
            "chunk_size": mc.ssm_chunk, "rope_theta": mc.rope_theta,
            "rms_norm_eps": mc.norm_eps, "time_step_min": 1e-3, "initializer_range": 0.02}


def seeded_weights(cfg: dict, seed: int) -> dict:
    """Float32 leaves by the reference's spec, every init moved off its
    constant (norms, a_log, dt_bias, d_skip, conv_b), so each path counts."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, init in zamba2_plain.param_spec(cfg):
        noise = torch.randn(shape, generator=gen)
        if init[0] == "normal":
            out[name] = noise * init[1]
        else:
            out[name] = noise * 0.1 + (1.0 if init[0] == "ones" else 0.0)
    return out


def tokens(cfg: dict, seed: int = 3, b: int = 2, s: int = 64) -> torch.Tensor:
    return torch.randint(0, cfg["vocab_size"], (b, s), generator=torch.Generator().manual_seed(seed))


def nest(flat: dict) -> dict:
    tree: dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    return tree


def program(mc, weights: dict):
    return registry.build(mc, device="cpu", params=nest({k: v.clone() for k, v in weights.items()}))


def gaps(mc, weights: dict, toks: torch.Tensor) -> dict:
    """{"loss": relative gap, leaf: gradient gap over the leaf's largest
    |entry|} of the program against the reference."""
    model = program(mc, weights)
    got = model.loss({"tokens": toks})
    names, params = zip(*model.named_parameters())
    leaves = {k: v.clone().requires_grad_() for k, v in weights.items()}
    assert list(names) == list(leaves)
    want = zamba2_plain.loss(leaves, toks, plain_cfg(mc))
    out = {"loss": abs(got.item() - want.item()) / abs(want.item())}
    for name, g, p, r in zip(names, torch.autograd.grad(got, params, allow_unused=True), params,
                             torch.autograd.grad(want, list(leaves.values()))):
        g = torch.zeros_like(p) if g is None else g  # a planted change may leave a leaf unread
        out[name] = float((g - r).abs().max()) / float(r.abs().max())
    return out


@pytest.fixture(scope="module")
def smoke():
    mc = get_smoke_config(ARCH)
    return mc, seeded_weights(plain_cfg(mc), 5), tokens(plain_cfg(mc))


@pytest.mark.parametrize("remat", ["full", "none"])
def test_loss_and_every_gradient_match_the_plain_reference(smoke, remat):
    mc, w, toks = smoke
    found = gaps(mc.with_(remat=remat), w, toks)
    bad = {k: v for k, v in found.items() if not v <= REL}
    assert not bad, bad
    assert len(found) == 1 + len(w)


def _residual_keeps_t(plain_mamba):
    def mutated(lp, x, cfg, added=None):
        return plain_mamba(lp, x if added is None else x + added, cfg)
    return mutated


def _adapters_dropped(plain_shared):
    def mutated(sp, hp, x, e, cfg, angles):
        return plain_shared(sp, dict(hp, adapter_b=torch.zeros_like(hp["adapter_b"])), x, e, cfg,
                            angles)
    return mutated


@pytest.mark.parametrize("name,fn,mutation", [
    ("residual x + t", "_mamba", _residual_keeps_t),
    ("adapters dropped", "_shared", _adapters_dropped)])
def test_a_planted_change_fails_the_comparison(smoke, monkeypatch, name, fn, mutation):
    mc, w, toks = smoke
    monkeypatch.setattr(zamba2, fn, mutation(getattr(zamba2, fn)))
    found = gaps(mc, w, toks)
    assert max(found.values()) > 100 * REL, (name, found)


def test_the_benchmark_copy_gives_the_tests_loss(smoke):
    sys.path.insert(0, str(ROOT))
    try:
        from fpisa_bench import spec
    finally:
        sys.path.remove(str(ROOT))
    bench = spec.reference("zamba2_7b")
    mc, w, toks = smoke
    cfg = plain_cfg(mc)
    assert bench.param_spec(cfg) == zamba2_plain.param_spec(cfg)
    assert torch.equal(bench.loss(w, toks, cfg), zamba2_plain.loss(w, toks, cfg))


def test_shared_block_weights_take_every_application_gradient(smoke):
    """Application 0 and 2 use shared block 0, application 1 block 1: block
    0's gradient is the sum of its two applications', each with its own
    adapter."""
    mc, w, toks = smoke
    assert [j % mc.num_mem_blocks for j in range(len(mc.hybrid_layer_ids))] == [0, 1, 0]
    model = program(mc, w)
    loss = model.loss({"tokens": toks})
    (g,) = torch.autograd.grad(loss, [model.shared["mlp"]["gate_up"]])
    assert g[0].abs().max() > 0 and g[1].abs().max() > 0
    (ga,) = torch.autograd.grad(model.loss({"tokens": toks}), [model.hybrid["adapter_a"]])
    assert all(ga[j].abs().max() > 0 for j in range(3))


def test_published_and_cut_parameter_counts():
    full = get_config(ARCH)
    assert registry.param_count(registry.build(full, device="meta")) == 7_356_749_648
    cut = full.with_(num_layers=24, hybrid_layer_ids=(6, 11, 17, 23))
    assert registry.param_count(registry.build(cut, device="meta")) == 2_733_050_240
    bench = full.with_(num_layers=12, hybrid_layer_ids=(6, 11))  # zamba2_train_4k's cut
    assert registry.param_count(registry.build(bench, device="meta")) == 1_757_853_120
    assert len(full.hybrid_layer_ids) == 13 and full.resolved_head_dim == 224
    assert zamba2.scale(full) == (224 / 2) ** -0.5


def test_one_traced_step_opens_each_block_span(smoke):
    """Remat "full": every block's span opens at the forward and again at
    its recompute in the backward."""
    from repro_torch import trace
    from repro_torch.core.agg import AggConfig
    from repro_torch.optim import optimizers
    from repro_torch.train.step import make_train_step

    mc, w, toks = smoke
    model = program(mc, w)
    opt = optimizers.OptConfig(name="adamw")
    step = make_train_step(model, AggConfig(strategy="fpisa"), opt, toks.shape[0])
    state = optimizers.init([p for _, p in model.named_parameters()], opt)
    tracer = trace.enable()
    try:
        step(state, {"tokens": toks})
    finally:
        trace.disable()
    names = [s["name"] for s in tracer.spans]
    assert names.count("zamba2.mamba_block") == 2 * mc.num_layers
    assert names.count("zamba2.shared_block") == 2 * len(mc.hybrid_layer_ids)
    assert names.count("train.forward_backward") == 1


def test_unsupported_paths_raise(smoke):
    from repro_torch.core.agg import AggConfig
    from repro_torch.optim import optimizers
    from repro_torch.train.step import make_train_step

    mc, w, _ = smoke
    with pytest.raises(ValueError, match="zamba2"):
        program(mc.with_(remat="dots"), w)
    with pytest.raises(ValueError, match="zamba2"):
        registry.build(mc.with_(mlp="gelu"), device="meta")
    model = program(mc, w)
    with pytest.raises(ValueError, match="zamba2"):
        model.init_cache(1, 16)
    with pytest.raises(ValueError, match="zamba2"):
        model.prefill(torch.zeros((1, 4), dtype=torch.int64), None)
    with pytest.raises(ValueError, match="zamba2"):
        model.decode_step(torch.zeros((1, 1), dtype=torch.int64), None)
    with pytest.raises(ValueError, match="zamba2"):
        make_train_step(model, AggConfig(), optimizers.OptConfig(name="adamw"), 2,
                        mesh=object())


def test_the_groups_normalise_on_their_own():
    """The gated norm of the zamba2 family by B/C group; the reference's
    families over the whole inner width."""
    from repro_torch.models import mamba2

    mc = get_smoke_config(ARCH)
    gen = torch.Generator().manual_seed(1)
    y, z = (torch.randn((2, 3, mc.ssm_d_inner), generator=gen) for _ in range(2))
    w = torch.ones(mc.ssm_d_inner)
    got = mamba2.gated_norm(y, z, w, mc)
    half = mc.ssm_d_inner // 2
    for part in (slice(0, half), slice(half, None)):
        g = (y * torch.sigmoid(z) * z)[..., part]
        torch.testing.assert_close(got[..., part], g * torch.rsqrt(g.square().mean(-1, True) + 1e-5))
    whole = mamba2.gated_norm(y, z, w, mc.with_(family="hybrid"))
    assert not torch.allclose(whole, got)


def test_launch_train_runs_the_smoke_config():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--arch", ARCH,
         "--smoke", "--steps", "2", "--global-batch", "2", "--seq-len", "32"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**__import__("os").environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    steps = [line for line in out.stdout.splitlines() if line.startswith("[train] step")]
    assert len(steps) == 2, out.stdout[-3000:]
