"""Training launcher of the port: data-parallel training with FPISA gradient
aggregation (torch port of ``repro.launch.train``).

Usage (one card):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --steps 3 --global-batch 8 --seq-len 512 --agg fpisa
on the CPU, at smoke size:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch qwen1.5-0.5b --smoke --steps 3 --global-batch 4 --seq-len 64
and across ranks under ``torchrun`` (rank and world size from its
environment; NCCL on the card, gloo on the CPU). Bucketed, traced and
autotuned aggregation (``--bucket-bytes N|auto``, ``--trace-out PATH``,
``--agg-chunk N``) take the reference's flags, e.g.
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch qwen1.5-0.5b --smoke --steps 3 --global-batch 4 --seq-len 64 \
      --bucket-bytes auto --trace-out /tmp/t.jsonl
The trace file is written on exit (JSONL, or chrome://tracing JSON for a
path ending in ``.chrome.json``).

Not ported yet, and refused: ``--ckpt-dir``, ``--fault-plan`` and
``--num-hosts`` (the elastic runtime).
"""
from __future__ import annotations

import argparse
import os
from time import perf_counter

import torch
import torch.distributed as dist

from repro_torch import NotPortedError, resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.agg import AggConfig, add_agg_args, group_rank, world_size
from repro_torch.data.pipeline import ShardedLoader, SyntheticCorpus
from repro_torch.models.registry import build, param_count
from repro_torch.optim import optimizers
from repro_torch.trace import add_trace_args
from repro_torch.trace import from_args as trace_from_args
from repro_torch.train.step import make_train_step


def train_loop(cfg, *, steps: int, global_batch: int, seq_len: int,
               agg: AggConfig | None = None, device=None, group=None,
               log_every: int = 10, opt_overrides: dict | None = None,
               seed: int = 0, params: dict | None = None):
    """Plain data-parallel training loop; returns (model, opt_state, losses).

    ``device`` None means the card. ``group`` is the data-parallel process
    group (None: the default group, or a world of one) or a
    ``(pod_group, data_group)`` pair. ``params`` replaces the seeded
    initialization (a parameter tree, e.g. exported from the reference).
    Every rank generates the same global batch and trains on its contiguous
    slice, as the reference shards the batch over replicas."""
    device = resolve_device(device)
    agg = agg or AggConfig()
    world = world_size(group)
    rank = group_rank(group)
    model = build(cfg, device=device, seed=seed, params=params)
    opt_kw = {"name": cfg.optimizer, "lr": cfg.learning_rate}
    opt_kw.update(opt_overrides or {})
    opt_cfg = optimizers.OptConfig(**opt_kw)
    opt_state = optimizers.init(list(model.parameters()), opt_cfg)
    step_fn = make_train_step(model, agg, opt_cfg, global_batch, group)
    loader = ShardedLoader(SyntheticCorpus(cfg.vocab_size, seed), global_batch, seq_len)
    local = global_batch // world

    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"[train] {cfg.name}: {param_count(model)/1e6:.1f}M params, "
        f"device={device}, world={world}, agg={agg.strategy}, "
        f"bucket_bytes={agg.bucket_bytes}")
    history = []
    for step in range(steps):
        t0 = perf_counter()
        tokens = loader.batch_at(step)["tokens"][rank * local:(rank + 1) * local]
        opt_state, metrics = step_fn(opt_state, torch.from_numpy(tokens).to(device))
        loss = float(metrics["loss"])  # waits for the device
        dt = perf_counter() - t0
        history.append(loss)
        if step % log_every == 0 or step == steps - 1:
            tok_s = global_batch * seq_len / dt
            say(f"[train] step {step:5d} loss {loss:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} {tok_s:,.0f} tok/s")
    return model, opt_state, history


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
    for flag in ("--ckpt-dir", "--fault-plan", "--num-hosts"):
        ap.add_argument(flag, default=None, help="not ported yet")
    args = ap.parse_args(argv)
    for flag in ("ckpt_dir", "fault_plan", "num_hosts"):
        if getattr(args, flag) is not None:
            ap.error(str(NotPortedError("--" + flag.replace("_", "-"))))

    try:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
        agg = AggConfig.from_args(args)
    except (ValueError, KeyError, NotPortedError) as e:
        ap.error(str(e))
    device = resolve_device(args.device)
    _init_from_env(device)
    session = trace_from_args(args)
    try:
        train_loop(cfg, steps=args.steps, global_batch=args.global_batch,
                   seq_len=args.seq_len, agg=agg, device=device)
    finally:
        session.finish()
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
