"""The plain references against the program on the CPU, at the size of the
program's SMOKE preset of qwen1.5-0.5b (``tests/small.py``), in float32:
the model's loss and every gradient, one training step's readings, and the
stacked aggregation bit for bit."""
from __future__ import annotations

import torch

from fpisa_bench import common, fpisa_ref, spec
from fpisa_bench.kinds import agg as agg_kind
from fpisa_bench.kinds import train
from fpisa_bench.tests.small import SIZES, run_cpu, small_cell


def test_small_cell_is_the_programs_smoke_preset():
    from repro_torch.configs.qwen15_0_5b import SMOKE

    mc = train.program_config(small_cell("qwen_train_4k").config)
    keep = ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff", "vocab_size",
            "param_dtype", "activation_dtype", "attn_q_chunk", "qkv_bias", "tie_embeddings")
    assert {k: getattr(mc, k) for k in keep} == {k: getattr(SMOKE, k) for k in keep}
    assert len(SIZES) == 6


def test_reference_loss_and_gradients_equal_the_programs():
    from repro_torch.models import registry

    cell = small_cell("qwen_train_4k")
    cfg = cell.config
    ref = spec.reference(cell.config_name)
    w = common.make_weights(ref.param_spec(cfg), 5, torch.device("cpu"), torch.float32)
    gen = torch.Generator().manual_seed(0)
    for name, t in w.items():  # biases and norms off their init, so every path counts
        if name.rsplit(".", 1)[1] in ("bk", "bq", "bv") or name.endswith("ln1.w"):
            t.add_(0.05 * torch.randn(t.shape, generator=gen))
    model = registry.build(train.program_config(cfg), device="cpu",
                           params=common.nest({k: v.clone() for k, v in w.items()}))
    tokens = train.batches(cfg, cell.traffic, 5, 1, "cpu")[0]
    got = model.loss({"tokens": tokens})
    leaves = {k: v.clone().requires_grad_() for k, v in w.items()}
    want = ref.loss(leaves, tokens, cfg)
    assert abs(got.item() - want.item()) <= 1e-5 * abs(want.item())
    for (name, _), g, r in zip(model.named_parameters(),
                               torch.autograd.grad(got, list(model.parameters())),
                               torch.autograd.grad(want, list(leaves.values()))):
        assert (g - r).norm() <= 1e-5 * r.norm(), name


def test_one_training_step_reads_alike():
    cell = small_cell("qwen_train_4k")
    cell.traffic = dict(cell.traffic, check_steps=1)
    r = run_cpu(cell, seconds=0)
    assert r.window.count == 0
    gaps = train.compare(r.readings["program"], r.readings["reference"])
    assert gaps["loss_gap"] <= 1e-6 and gaps["grad_gap"] <= 1e-5 and gaps["change_gap"] <= 1e-5


def test_stacked_aggregation_equals_the_plain_fpisa_sum():
    from repro_torch.core.agg import AggConfig, Aggregator

    cell = small_cell("qwen_agg_w4")
    pspec = spec.reference(cell.config_name).param_spec(cell.config)
    (tree,) = agg_kind.make_trees(pspec, dict(cell.traffic, inputs=1), 7, torch.device("cpu"))
    tree["layers.ln1.w"][1, 0, :3] = 0.0  # zeros and a denormal in a block
    tree["layers.ln1.w"][2, 0, 3] = 1e-40
    out = Aggregator(AggConfig(**cell.traffic["agg"]), stacked=True).allreduce_tree(tree)
    assert agg_kind.mismatches([out], tree) == [0]
    one = {k: v[:1].float() for k, v in tree.items()}  # one worker in float32, as training has
    flat = Aggregator(AggConfig(**cell.traffic["agg"])).allreduce_tree(
        {k: v[0] for k, v in one.items()})
    for k, v in one.items():
        assert torch.equal(flat[k].view(torch.int32), fpisa_ref.aggregate(v).view(torch.int32))


def test_weights_repeat_with_the_seed():
    spec_ = [("a", (3, 5), ("normal", 0.02)), ("b", (4,), ("ones",)), ("c", (2, 2), ("normal", 1.0))]
    one = common.make_weights(spec_, 2**33 + 5, torch.device("cpu"), torch.bfloat16)
    two = common.make_weights(spec_, 2**33 + 5, torch.device("cpu"), torch.bfloat16)
    other = common.make_weights(spec_, 6, torch.device("cpu"), torch.bfloat16)
    assert all(torch.equal(one[k], two[k]) for k in one)
    assert not torch.equal(one["a"], other["a"]) and torch.equal(one["b"], torch.ones(4))
