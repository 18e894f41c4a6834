"""Training launcher of the port: data-parallel training with FPISA gradient
aggregation (torch port of ``repro.launch.train``).

Usage (one card):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --steps 3 --global-batch 8 --seq-len 512 --agg fpisa
on the CPU, at smoke size:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch qwen1.5-0.5b --smoke --steps 3 --global-batch 4 --seq-len 64
``--arch`` takes every config (dense, moe, ssm, hybrid, vlm and the
encoder-decoder; a vlm batch carries seeded patch features and an
encoder-decoder batch seeded audio frames, ``global_batch_at``), e.g.
``--arch mamba2-780m``, ``zamba2-7b``, ``arctic-480b``, ``llava-next-34b``,
``whisper-medium``;
and across ranks under ``torchrun`` (rank and world size from its
environment; NCCL on the card, gloo on the CPU). Bucketed, traced and
autotuned aggregation (``--bucket-bytes N|auto``, ``--trace-out PATH``,
``--agg-chunk N``) take the reference's flags, e.g.
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch qwen1.5-0.5b --smoke --steps 3 --global-batch 4 --seq-len 64 \
      --bucket-bytes auto --trace-out /tmp/t.jsonl
The trace file is written on exit (JSONL, or chrome://tracing JSON for a
path ending in ``.chrome.json``).

``--ckpt-dir DIR`` commits a params+opt bundle every ``--ckpt-every`` steps
and resumes from the newest one. ``--fault-plan`` (e.g. ``kill:2@4``) or
``--num-hosts N`` route the run through the elastic controller
(``runtime.controller.run_controller``): N hosts, one per rank,
heartbeats, switch-slot reclamation and bit-identical resume on the
survivors, with deterministic algorithms on the card
(``runtime.elastic.reproducible``), e.g. on the CPU over gloo
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --device cpu --arch qwen1.5-0.5b --smoke --steps 10 --global-batch 8 \
      --seq-len 32 --fault-plan kill:2@4 --num-hosts 4

``--model-parallel M`` and ``--pods P`` train on a ``DeviceMesh``
(``launch/mesh.py::make_mesh_for``): the weights are placed by
``sharding/rules.py`` and the step is ``train/step.py``'s mesh step, e.g.
tensor parallelism over 2 of 4 gloo ranks on the CPU
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --device cpu --arch qwen1.5-0.5b --smoke --steps 3 --global-batch 8 \
      --seq-len 32 --model-parallel 2
With neither flag the run is the plain data-parallel one.
"""
from __future__ import annotations

import argparse
import os
from time import perf_counter

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import NotPortedError, resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.agg import AggConfig, add_agg_args, group_rank, world_size
from repro_torch.data.pipeline import ShardedLoader, SyntheticCorpus
from repro_torch.launch.mesh import make_mesh_for, mesh_shape
from repro_torch.models.registry import build, param_count
from repro_torch.optim import optimizers
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.sharding import rules
from repro_torch.trace import add_trace_args
from repro_torch.trace import from_args as trace_from_args
from repro_torch.train.step import make_train_step


def train_loop(cfg, *, steps: int, global_batch: int, seq_len: int,
               agg: AggConfig | None = None, device=None, group=None,
               ckpt_dir: str | None = None, ckpt_every: int = 50,
               log_every: int = 10, opt_overrides: dict | None = None,
               seed: int = 0, params: dict | None = None, mesh=None):
    """Plain data-parallel training loop; returns (model, opt_state, losses),
    the losses of the steps this call ran.

    ``device`` None means the card. ``group`` is the data-parallel process
    group (None: the default group, or a world of one) or a
    ``(pod_group, data_group)`` pair. ``params`` replaces the seeded
    initialization (a parameter tree, e.g. exported from the reference).
    Every rank generates the same global batch and trains on its contiguous
    slice, as the reference shards the batch over replicas.

    With ``ckpt_dir``: the newest bundle there (params and optimizer state,
    ``runtime/checkpoint.py``) is restored and training resumes after its
    step; a bundle is committed after every step > 0 that is a multiple of
    ``ckpt_every``, in the background, by the group's rank 0. A directory
    written in the older split layout (params at ``<dir>``, optimizer
    state at ``<dir>_opt``) is restored once. The steps run in the same
    mode with or without ``ckpt_dir``: a resumed run repeats the
    uninterrupted one bit for bit where the step's ops repeat their bits,
    which ``chip_smoke.py`` checks on the card (``[determinism]``,
    ``[ckpt]``).

    ``mesh`` (a ``DeviceMesh`` of ``launch/mesh.py``, instead of
    ``group``): the parameters and the optimizer's moments are placed on
    it by ``sharding.rules.distribute`` (after a restore too: checkpoints
    hold whole tensors), each rank trains on its ``rules.batch_slice`` of
    the global batch, and the step is ``train/step.py``'s mesh step. A
    checkpoint is gathered whole on every rank and written by rank 0."""
    device = resolve_device(device)
    agg = agg or AggConfig()
    if mesh is not None and group is not None:
        raise ValueError("pass a mesh or a group, not both")
    world = world_size(group)
    rank = group_rank(group) if mesh is None else dist.get_rank()
    model = build(cfg, device=device, seed=seed, params=params)
    opt_kw = {"name": cfg.optimizer, "lr": cfg.learning_rate}
    opt_kw.update(opt_overrides or {})
    opt_cfg = optimizers.OptConfig(**opt_kw)
    opt_state = optimizers.init(list(model.parameters()), opt_cfg)
    say = print if rank == 0 else (lambda *a, **k: None)

    start_step = 0
    saver = None
    if ckpt_dir:
        saver = ckpt.AsyncCheckpointer(ckpt_dir) if rank == 0 else None
        latest = ckpt.latest_step(ckpt_dir)
        if latest is not None:
            like = ckpt.state_trees(model, opt_state)
            try:
                # atomic bundle: params and opt always come from the SAME step
                trees, _ = ckpt.restore_bundle(ckpt_dir, latest, like)
            except ValueError:
                # pre-bundle layout (params at <dir>, opt at <dir>_opt) from
                # an older run: restore it once; the next save commits a
                # bundle and the split dirs stop mattering
                trees = {"params": ckpt.restore(ckpt_dir, latest, like["params"])[0],
                         "opt": ckpt.restore(ckpt_dir + "_opt", latest, like["opt"])[0]}
            opt_state = ckpt.load_state(model, opt_state, trees)
            start_step = latest + 1
            say(f"[train] resumed from step {latest}")

    if mesh is not None:
        opt_state = rules.distribute(model, cfg, mesh, opt_state)
        rows = rules.batch_slice(mesh, global_batch)
    else:
        rows = slice(rank * (global_batch // world), (rank + 1) * (global_batch // world))
    step_fn = make_train_step(model, agg, opt_cfg, global_batch, group, mesh=mesh)
    loader = ShardedLoader(SyntheticCorpus(cfg.vocab_size, seed), global_batch, seq_len)

    say(f"[train] {cfg.name}: {param_count(model)/1e6:.1f}M params, "
        f"device={device}, world={world}, agg={agg.strategy}, "
        f"bucket_bytes={agg.bucket_bytes}"
        + ("" if mesh is None else f", mesh={dict(mesh_shape(mesh).shape)}"))
    history = []
    for step in range(start_step, steps):
        t0 = perf_counter()
        batch = global_batch_at(cfg, loader, seed, step)
        batch = {k: torch.from_numpy(v[rows]).to(device) for k, v in batch.items()}
        opt_state, metrics = step_fn(opt_state, batch)
        loss = float(metrics["loss"])  # waits for the device
        dt = perf_counter() - t0
        history.append(loss)
        if step % log_every == 0 or step == steps - 1:
            tok_s = global_batch * seq_len / dt
            say(f"[train] step {step:5d} loss {loss:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} {tok_s:,.0f} tok/s")
        if ckpt_dir and step > 0 and step % ckpt_every == 0:
            trees = ckpt.state_trees(model, opt_state)
            if mesh is not None:  # collective: every rank gathers
                trees = ckpt.map_tensors(lambda t: t.full_tensor(), trees)
            if saver:
                saver.save_bundle(step, trees, {"loss": loss})
    if saver:
        saver.wait()
    return model, opt_state, history


def global_batch_at(cfg, loader: ShardedLoader, seed: int, step: int) -> dict:
    """The global batch of ``step``: the loader's ``tokens`` and, for vlm,
    ``patch_embeds`` (B, num_patches, d_model), for the encoder-decoder
    ``frames`` (B, num_frames, d_model); float32, standard normal from numpy
    seeded by (seed, step) under a tag of their own: the reference's models
    take precomputed features of those shapes (its conv frontend is a stub)
    and its data pipeline makes none."""
    batch = loader.batch_at(step)

    def features(rows: int, tag: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([seed, step, tag]))
        return rng.standard_normal((loader.global_batch, rows, cfg.d_model), dtype=np.float32)

    if cfg.family == "vlm":
        batch["patch_embeds"] = features(cfg.num_patches, 0x7A7C4)
    if cfg.is_encoder_decoder:
        batch["frames"] = features(cfg.num_frames, 0xF4A3E)
    return batch


def _init_from_env(device: torch.device):
    """Join the process group ``torchrun`` describes, if any."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    add_agg_args(ap)  # the shared --agg-* flags (repro_torch.core.agg)
    add_trace_args(ap)  # the shared --trace-* flags (repro_torch.trace)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fault-plan", default="",
                    help="fault-injection spec, e.g. 'kill:2@5' or "
                         "'kill:2@5,revive:2@20,slow:3@4x6': routes the run "
                         "through the elastic controller "
                         "(repro_torch/runtime/controller.py): heartbeats, switch-"
                         "slot reclamation, regrouping and bit-identical resume")
    ap.add_argument("--num-hosts", type=int, default=None,
                    help="logical worker / host count for the elastic "
                         "controller (default: one per rank); implies the "
                         "controller path even without --fault-plan")
    ap.add_argument("--model-parallel", type=int, default=None,
                    help="train on a (data, model) DeviceMesh with this 'model' axis "
                         "(tensor parallelism; sharding/rules.py places the weights)")
    ap.add_argument("--pods", type=int, default=None,
                    help="train on a (pod, data, model) DeviceMesh with this many pods")
    args = ap.parse_args(argv)

    try:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
        agg = AggConfig.from_args(args)
    except (ValueError, KeyError, NotPortedError) as e:
        ap.error(str(e))
    elastic = bool(args.fault_plan or args.num_hosts)
    if elastic and agg.chunk_elems:
        ap.error("--agg-chunk is not supported on the elastic controller path "
                 "(stacked aggregation; use --bucket-bytes instead)")
    meshed = args.model_parallel is not None or args.pods is not None
    if elastic and meshed:
        ap.error("--model-parallel / --pods do not combine with the elastic controller")
    if elastic:
        # cuBLAS reads its workspace setting when CUDA starts; the
        # controller's deterministic mode needs it (runtime.elastic.reproducible)
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    device = resolve_device(args.device)
    _init_from_env(device)
    session = trace_from_args(args)
    try:
        if elastic:
            from repro_torch.runtime.controller import run_controller

            try:  # the controller's argument checks are usage errors
                run_controller(cfg, steps=args.steps, global_batch=args.global_batch,
                               seq_len=args.seq_len, agg=agg, num_hosts=args.num_hosts,
                               ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                               fault_plan=args.fault_plan, device=device)
            except ValueError as e:
                ap.error(str(e))
            return
        mesh = None
        if meshed:
            try:
                mesh = make_mesh_for(int(os.environ.get("WORLD_SIZE", "1")),
                                     args.model_parallel or 1, args.pods or 1)
            except (ValueError, RuntimeError) as e:  # a layout, or no torchrun group
                ap.error(str(e))
        train_loop(cfg, steps=args.steps, global_batch=args.global_batch,
                   seq_len=args.seq_len, agg=agg, device=device,
                   ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, mesh=mesh)
    finally:
        session.finish()
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
