"""``remat="dots"`` in the port (``repro_torch.models.transformer.dots_policy``,
selective checkpointing) against the reference's
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``, at smoke size,
both sides starting from the SAME weights (the shared harness
``torch_model_parity`` and its tolerances: logits, loss and every gradient
leaf 2e-5 relative); inputs from numpy seeds.

* Every config, at full size, builds under "dots" (on the meta device).
* Each decoder-only family (dense, moe, ssm, hybrid, vlm) at 2 x 64 (two of
  the reference's 32-token attention chunks): forward, loss and every
  gradient leaf under "dots" against the reference's "dots" run.
* "dots" with ``flash_remat`` flipped (the chunked attention's own
  checkpoint nested in the selective one, or taken out of it) gives the
  bits of "full".
* The products the policy saves, layer for layer, are the reference's
  residuals (``jax.ad_checkpoint.print_saved_residuals``) less each layer's
  input carry, on dense, moe, ssm and vlm: q, k and v, the attention's
  output projection, the MLP's ``wi`` and ``wg`` products, the router's
  logits, mamba's ``in_proj``; not the down projections or mamba's
  ``out_proj``, which no backward reads. The port saves no product beyond
  the reference's.

"dots" == "full" == "none" bit for bit is held in test_torch_models.py
(each decoder-only family) and test_torch_encdec.py (whisper, where "dots"
runs as "full", as in the reference).
"""
import contextlib
import io
import math
import re
from collections import Counter

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.ad_checkpoint  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from torch_model_parity import (check_forward_and_grads, jax_batch, make_batch,  # noqa: E402
                                pair, torch_batch)

FAMILY_ARCH = {"dense": "internlm2-20b", "moe": "arctic-480b", "ssm": "mamba2-780m",
               "hybrid": "zamba2-7b", "vlm": "llava-next-34b"}
CPU = torch.device("cpu")


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_every_config_builds_under_dots(arch):
    model = build(configs.get_config(arch).with_(remat="dots"), device=torch.device("meta"))
    assert model.cfg.remat == "dots"


@pytest.mark.parametrize("family", list(FAMILY_ARCH))
def test_dots_matches_the_reference(family):
    """At test_torch_mamba2's batch (2 x 64, seed 4) for every family."""
    jm, jp, pm = pair(FAMILY_ARCH[family], remat="dots")
    check_forward_and_grads(jm, jp, pm, make_batch(pm.cfg, 2, 64, seed=4))


@pytest.mark.parametrize("family", list(FAMILY_ARCH))
def test_dots_with_flash_remat_flipped_gives_the_bits_of_full(family):
    cfg = configs.get_smoke_config(FAMILY_ARCH[family])
    batch = torch_batch(make_batch(cfg, 2, 64, seed=11))
    runs = []
    for kw in ({"remat": "full"}, {"remat": "dots", "flash_remat": not cfg.flash_remat}):
        model = build(cfg.with_(**kw), device=CPU, seed=0)
        loss = model.loss(batch)
        runs.append([loss] + list(torch.autograd.grad(loss, list(model.parameters()))))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _saved_products(model, batch: dict, monkeypatch) -> Counter:
    """(rows, columns) of each product that ``dots_policy`` saves in one
    forward."""
    policy, saved = transformer.dots_policy, Counter()

    def spy(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            assert op in transformer.NO_BATCH_PRODUCTS, op
            x, w = args[-2:]  # mm(x, w), addmm(bias, x, w)
            saved[(x.shape[0], w.shape[1])] += 1
        return decision

    monkeypatch.setattr(transformer, "dots_policy", spy)
    model.loss(batch)
    return saved


def _reference_products(jm, jp, batch: dict, rows: int, layers: int, d_model: int) -> Counter:
    """The reference's per-layer residuals as (rows, columns): the stacked
    outputs of its layer scan, each ``layers`` products of ``rows`` token
    rows, less one (rows, d_model) input carry per layer."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax.ad_checkpoint.print_saved_residuals(lambda p: jm.loss(p, jax_batch(batch)), jp)
    found = Counter()
    for line in out.getvalue().splitlines():
        m = re.match(r"\w+\[([\d,]+)\] output of scan", line)
        shape = tuple(int(n) for n in m.group(1).split(",")) if m else ()
        if len(shape) >= 4:  # (L, ...) stacked by the scan; the final carry is (B, S, d)
            assert shape[0] == layers, line
            found[(rows, math.prod(shape[1:]) // rows)] += layers
    found[(rows, d_model)] -= layers
    return +found


@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "vlm"])
def test_dots_saves_the_reference_residuals(family, monkeypatch):
    jm, jp, pm = pair(FAMILY_ARCH[family], remat="dots")
    cfg = pm.cfg
    batch = make_batch(cfg, 2, 32, seed=3)
    rows = 2 * (32 + cfg.num_patches)
    want = _reference_products(jm, jp, batch, rows, cfg.num_layers, cfg.d_model)
    got = _saved_products(pm, torch_batch(batch), monkeypatch)
    assert want and got == want
