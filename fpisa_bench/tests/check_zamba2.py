"""The zamba2 cell on the CPU: a tiny copy of ``zamba2_train_4k`` (the
cell's own configuration and mix files through ``small.py``, cut further to
the program's SMOKE preset of ``zamba2-7b-published``: two shared blocks
over three applications at the irregular layers 1, 2, 4, 2 B/C groups,
head_dim = 2 d / heads) runs end to end through the harness in float32 and
is ``correct``; with half of each batch left out it is not. The named
metrics read nothing on the CPU but ``mfu.zamba2``'s flop count.

    PYTHONPATH=src python -m pytest -q fpisa_bench/tests/check_zamba2.py
"""
from __future__ import annotations

from fpisa_bench import counts_zamba2
from fpisa_bench.calibrate import half_batch
from fpisa_bench.kinds import train
from fpisa_bench.tests.small import run_cpu, small_cell

WORKLOAD = "zamba2_train_4k"
ZAMBA2_SMOKE = dict(attention_head_dim=32, ffn_hidden_size=128, num_hidden_layers=6,
                    hybrid_layer_ids=[1, 2, 4], mamba_d_state=16, mamba_headdim=16,
                    chunk_size=16, adapter_rank=8)


def tiny_cell():
    cell = small_cell(WORKLOAD)
    cfg = dict(cell.config, **ZAMBA2_SMOKE)
    cfg["program"] = dict(cfg["program"], head_dim=32, ssm_state=16, ssm_head_dim=16,
                          ssm_chunk=16, hybrid_layer_ids=[1, 2, 4], adapter_rank=8)
    cell.config = cfg
    return cell


def test_tiny_cell_is_the_programs_smoke_preset():
    from repro_torch.configs import get_smoke_config

    mc, smoke = train.program_config(tiny_cell().config), get_smoke_config("zamba2-7b-published")
    keep = ("family", "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
            "vocab_size", "mlp", "ssm_state", "ssm_head_dim", "ssm_expand", "ssm_chunk",
            "ssm_groups", "ssm_conv_width", "hybrid_layer_ids", "num_mem_blocks",
            "adapter_rank", "param_dtype", "activation_dtype", "attn_q_chunk", "tie_embeddings",
            "norm_eps", "rope_theta")
    assert {k: getattr(mc, k) for k in keep} == {k: getattr(smoke, k) for k in keep}


def test_tiny_cell_runs_correct():
    r = run_cpu(tiny_cell())
    assert r.correct and r.failed == 0 and r.window.count > 0, r.checks
    gaps = r.checks
    assert all(v < 1e-4 for v, _ in gaps.values()), gaps


def test_tiny_cell_with_half_the_batch_fails():
    with half_batch():
        r = run_cpu(tiny_cell())
    assert not r.correct, r.checks


def test_flop_count_against_a_hand_count():
    """The cut (12 layers, 2 applications): 1,757,249,536 product parameters
    a token, 11.03 GFLOP a token at 4,096."""
    from fpisa_bench import spec

    cfg = spec.config("zamba2_7b")
    mamba = 3584 * (2 * 7168 + 2 * 2 * 64 + 112) + 7168 * 3584
    app = 3 * 7168 * 7168 + 7168 * 3584 + 3584 * 28672 + 14336 * 3584 \
        + 3584 * 128 + 128 * 28672 + 3584 * 3584
    assert counts_zamba2.matmul_params(cfg) == 12 * mamba + 2 * app + 3584 * 32000 \
        == 1_757_249_536
    attention = 12 * 224 * 32 * 2 * 4097 / 2
    ssd = 3 * 12 * (2 * 64 * 2 * 128.5 + 2 * 64 * 112 * 128.5 + 4 * 64 * 64 * 112)
    assert counts_zamba2.train_flops_per_token(cfg, 4096) == 6 * 1_757_249_536 + attention + ssd
    assert round(counts_zamba2.train_flops_per_token(cfg, 4096) / 1e9, 2) == 11.03
