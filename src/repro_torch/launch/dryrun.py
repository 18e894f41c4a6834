"""Dry run: trace every (arch x shape x mesh) cell of the production mesh on
one CPU process and derive roofline terms from the ops it dispatches (torch
counterpart of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --multi-pod

The process joins a ``fake`` process group of the production mesh's size
(256 ranks, or 512 with ``--multi-pod``) as rank 0; its collectives return
at once. Under ``FakeTensorMode`` nothing is allocated or computed: the
model is built, placed by ``sharding/rules.py`` as DTensors on the mesh, and
one train step (``train/step.py``'s mesh step), prefill or decode step runs
on shapes alone, while ``launch/opscan.py`` counts its ops on rank 0's
shards. The fake group replaces the default process group, so a caller
(a test) runs this in a process of its own.

Per cell one JSON line with the reference's keys. ``per_device.arg_bytes``
is the sum of rank 0's shards of the step's arguments (parameters, AdamW's
moments, the batch; for serving the cache). XLA's ``temp_bytes`` (and the
peak built on it) has no counterpart in an eager trace and is not
reported. The roofline is one NVIDIA H100 SXM's (``launch/mesh.py``):
``compute_s`` = flops / 989 TFLOP/s (bf16 dense), ``memory_s`` = bytes /
3.35 TB/s, ``collective_s`` = wire bytes / 450 GB/s (NVLink, per
direction). Serving steps run each replica's rows on the mesh's other axes,
as training does (``replica_axes``). A cell that fails is a finding, not a
crash: its line carries the error. ``long_500k`` runs only for the
sub-quadratic families, as in the reference.

The flags are the reference's but ``--save-hlo``: an eager trace has no
HLO text to save.
"""
from __future__ import annotations

import argparse
import ast
import json
import math
import traceback
from time import perf_counter

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import SHAPES, ShapeConfig, shape_applicable
from repro_torch.core.agg import AggConfig, add_agg_args
from repro_torch.launch import opscan
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16,
                                     make_production_mesh, production_shape)
from repro_torch.trace import add_trace_args
from repro_torch.trace import from_args as trace_from_args


def model_flops(cfg, shape: ShapeConfig) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) for train; 2*N*D for inference."""
    n = active_param_count(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6 if shape.kind == "train" else 2
    return mult * n * tokens


def active_param_count(cfg) -> float:
    hd = cfg.resolved_head_dim
    if cfg.family == "ssm":
        di = cfg.ssm_d_inner
        per = cfg.d_model * (2 * di + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads) + di * cfg.d_model
        return cfg.num_layers * per + cfg.vocab_size * cfg.d_model * 2
    attn = cfg.d_model * hd * cfg.num_heads * 2 + cfg.d_model * hd * cfg.num_kv_heads * 2
    if cfg.family == "moe":
        ff = cfg.num_experts_per_token * 3 * cfg.d_model * cfg.d_ff
        if cfg.moe_dense_ff:
            ff += 3 * cfg.d_model * cfg.moe_dense_ff
    elif cfg.family == "hybrid":
        di = cfg.ssm_d_inner
        mamba = cfg.d_model * (2 * di + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads) + di * cfg.d_model
        ng = cfg.num_layers // cfg.hybrid_attn_every
        shared = ng * (attn + 3 * cfg.d_model * cfg.d_ff)
        return cfg.num_layers * mamba + shared + cfg.vocab_size * cfg.d_model * 2
    else:
        ff = 3 * cfg.d_model * cfg.d_ff
    layers = cfg.num_layers * (attn + ff)
    if cfg.is_encoder_decoder:
        layers += cfg.num_encoder_layers * (attn + 3 * cfg.d_model * cfg.d_ff)
        layers += cfg.num_layers * attn  # cross attention
    emb = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    return layers + emb


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree``."""
    total = 0
    for t in torch.utils._pytree.tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            local = t.to_local() if hasattr(t, "device_mesh") else t
            total += local.numel() * local.element_size()
    return total


def _local_batch(cfg, shape: ShapeConfig, mesh) -> dict:
    """This rank's rows of the cell's batch (fake tensors)."""
    from repro_torch.sharding import rules

    rows = rules.batch_slice(mesh, shape.global_batch)
    return {k: torch.zeros((rows.stop - rows.start, *v.shape[1:]), dtype=v.dtype)
            for k, v in S.input_specs(cfg, shape).items()}


def _map_paths(tree, fn, prefix: str = ""):
    """``tree`` (NamedTuples, tuples, tensors) with ``fn(path, leaf)``
    applied to every leaf, paths as ``rules.tree_paths`` names them."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_paths(v, fn, f"{prefix}/{k}" if prefix else k)
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_paths(v, fn, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def build_cell(cfg, shape: ShapeConfig, mesh, agg: AggConfig):
    """(fn, arg_bytes): the cell's step as a function of nothing, and the
    bytes of rank 0's shards of its arguments. Runs under FakeTensorMode."""
    from repro_torch.models.registry import build
    from repro_torch.optim import optimizers
    from repro_torch.sharding import rules
    from repro_torch.train.step import _swapped, make_train_step

    model = build(cfg, device=torch.device("cpu"))
    batch = _local_batch(cfg, shape, mesh)
    if shape.kind == "train":
        opt_cfg = optimizers.OptConfig(name=cfg.optimizer)
        opt = rules.distribute(model, cfg, mesh,
                               optimizers.init(list(model.parameters()), opt_cfg))
        step = make_train_step(model, agg, opt_cfg, shape.global_batch, mesh=mesh,
                               accum_steps=cfg.accum_steps)
        args = (list(model.parameters()), opt.m, opt.v, batch)
        return (lambda: step(opt, batch)), _local_bytes(args)

    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    # serving replicas: every (pod, data) coordinate serves its own rows on
    # the mesh's 'model' axis; FSDP shards are gathered over 'data' first
    rules.distribute(model, cfg, mesh)
    names = mesh.mesh_dim_names
    cmesh = mesh["model"]
    at = names.index("model")
    views = {}
    for name, p in model.named_parameters():
        whole = p.redistribute(mesh, [pl if a == "model" else Replicate()
                                      for a, pl in zip(names, p.placements)])
        views[name] = torch.nn.Parameter(DTensor.from_local(
            whole.to_local(), cmesh, [p.placements[at]], run_check=False,
            shape=p.shape, stride=p.stride()), requires_grad=False)
    rows = batch["tokens"].shape[0]
    # the serving methods run under inference_mode, whose tensors DTensor
    # cannot wrap; their bodies run here under no_grad
    cls = type(model)
    local = cls.init_cache.__wrapped__(model, rows, shape.seq_len)
    specs = rules.cache_pspecs(local, mesh, shape.global_batch, cfg)

    def place(path, t):
        if not isinstance(t, torch.Tensor):
            return t
        return distribute_tensor(t, cmesh, rules.placements(specs[path], cmesh),
                                 src_data_rank=None)

    cache = _map_paths(local, place)
    arg_bytes = _local_bytes((list(views.values()), cache, batch))

    def serve():
        with _swapped(model, views), implicit_replication(), torch.no_grad():
            if shape.kind == "prefill":
                extra = batch.get("frames", batch.get("patch_embeds"))
                return cls.prefill.__wrapped__(model, batch["tokens"], cache, extra)
            return cls.decode_step.__wrapped__(model, batch["tokens"], cache)

    return serve, arg_bytes


def run_cell(arch: str, shape_name: str, mesh, agg: AggConfig | None = None,
             overrides: dict | None = None) -> dict:
    """One cell on ``mesh`` (a DeviceMesh over the fake group)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.sharding import hints

    agg = agg or AggConfig()
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.with_(**overrides)
    shape = SHAPES[shape_name]
    names, sizes = mesh.mesh_dim_names, tuple(mesh.shape)
    nd = math.prod(sizes)
    rec = {
        "arch": arch, "shape": shape_name, "multi_pod": "pod" in names,
        "mesh": dict(zip(names, sizes)), "agg": agg.strategy, "status": "ok",
        "overrides": overrides or {}, "wire_bits": agg.wire_bits,
        "pod_wire_bits": agg.pod_wire_bits,
    }
    if not shape_applicable(cfg, shape):
        rec["status"] = "skipped"
        rec["reason"] = "long_500k requires sub-quadratic attention (see DESIGN.md)"
        return rec
    t0 = perf_counter()
    try:
        with FakeTensorMode(allow_non_fake_inputs=True), hints.use_mesh(mesh):
            fn, arg_bytes = build_cell(cfg, shape, mesh, agg)
            t_build = perf_counter() - t0
            with opscan.OpScan() as scan:
                fn()
        an = scan.analysis
        compute_t = an.flops / PEAK_FLOPS_BF16
        memory_t = an.hbm_bytes / HBM_BW
        coll_t = an.wire_bytes / NVLINK_BW
        mf = model_flops(cfg, shape)
        rec.update({
            "build_s": round(t_build, 1), "trace_s": round(perf_counter() - t0 - t_build, 1),
            "per_device": {
                "arg_bytes": arg_bytes,
                "op_flops": an.flops,
                "op_product_flops": an.product_flops,
                "op_bytes": an.hbm_bytes,
                "coll_wire_bytes": an.wire_bytes,
            },
            "roofline": {
                "compute_s": compute_t,
                "memory_s": memory_t,
                "collective_s": coll_t,
                "bottleneck": max(
                    ("compute", compute_t), ("memory", memory_t), ("collective", coll_t),
                    key=lambda kv: kv[1],
                )[0],
            },
            "model_flops_global": mf,
            "useful_flops_ratio": (mf / (an.flops * nd)) if an.flops else None,
            "collectives_by_kind": an.collectives,
        })
    except Exception as e:  # noqa: BLE001 — a failed cell is a finding, not a crash
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {str(e)[:2000]}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return rec


def fake_production_mesh(multi_pod: bool):
    """Join a ``fake`` process group of the production mesh's size as rank 0
    and return the mesh (on ``cpu``: nothing runs on a device)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=production_shape(multi_pod).size)
    return make_production_mesh(multi_pod, "cpu")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id or 'all'")
    ap.add_argument("--shape", default=None, help="shape name or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    add_agg_args(ap)  # the shared --agg-* flags (repro_torch.core.agg)
    add_trace_args(ap)  # the shared --trace-* flags (repro_torch.trace)
    ap.add_argument("--out", default=None, help="append JSON lines here")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (value parsed as python literal)")
    args = ap.parse_args(argv)
    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            overrides[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            overrides[k] = v
    try:
        agg = AggConfig.from_args(args)
    except ValueError as e:
        ap.error(str(e))
    archs = ARCH_NAMES if args.arch in (None, "all") else [args.arch]
    shapes = list(SHAPES) if args.shape in (None, "all") else [args.shape]
    mesh = fake_production_mesh(args.multi_pod)
    session = trace_from_args(args)
    try:
        for arch in archs:
            for shape in shapes:
                line = json.dumps(run_cell(arch, shape, mesh, agg, overrides or None))
                print(line, flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(line + "\n")
    finally:
        session.finish()


if __name__ == "__main__":
    main()
