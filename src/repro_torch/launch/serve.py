"""Serving launcher of the port (torch counterpart of ``examples/serve_lm.py``):
greedy decode over a Poisson request trace with either engine,
``--engine static`` (lockstep batches, dense per-slot KV) or ``--engine
continuous`` (continuous batching over the paged KV cache). Both serve the
same load-generated requests and aggregate their serving telemetry through
the ``Aggregator`` facade the trainers use (the shared ``--agg-*`` flags):
``fpisa`` launches K1/K2 on the card, ``fpisa_seq`` K6.

On the CPU, at smoke size (3 slots, max_len 32, pages of 8, 6 requests):
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \
      --engine continuous --agg-strategy fpisa
On the card, at full width (16 slots, max_len 1024, pages of 16, 32
requests with prompts of 64/256/512 tokens and budgets of 32/64/128):
  PYTHONPATH=src python -m repro_torch.launch.serve --engine continuous
``--arch`` takes every decoder-only config; the ssm and hybrid families
keep recurrent state with no sequence axis to page, so they serve through
``--engine static`` and the continuous engine refuses them (the
reference's error), e.g.
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \
      --arch mamba2-780m --engine static
The encoder-decoder (whisper-medium) needs audio frames at prefill, which
neither engine feeds: it is a usage error (``serve.engine.check_servable``).
"""
from __future__ import annotations

import argparse
from time import perf_counter

import torch

from repro_torch import NotPortedError, resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.agg import AggConfig, add_agg_args
from repro_torch.models.registry import build, param_count
from repro_torch.serve.engine import ServeEngine, check_servable
from repro_torch.serve.loadgen import PoissonLoadGen, latency_report
from repro_torch.serve.scheduler import ContinuousEngine
from repro_torch.trace import add_trace_args
from repro_torch.trace import from_args as trace_from_args

# (slots, max_len, page, requests, prompt lengths, budgets)
FULL_SIZES = (16, 1024, 16, 32, (64, 256, 512), (32, 64, 128))
SMOKE_SIZES = (3, 32, 8, 6, (4, 8), (4, 8))


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_agg_args(ap)  # the shared --agg-* flags (repro_torch.core.agg)
    add_trace_args(ap)  # the shared --trace-* flags (repro_torch.trace)
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    help="any decoder-only config (repro_torch.configs)")
    ap.add_argument("--engine", choices=("static", "continuous"), default="static",
                    help="serving engine")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config and a short trace")
    ap.add_argument("--requests", type=int, default=None,
                    help="trace length (default 32, smoke 6)")
    ap.add_argument("--rate", type=float, default=1.0,
                    help="Poisson arrival rate, requests per scheduler step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    try:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
        check_servable(cfg)
        agg = AggConfig.from_args(args)
    except (ValueError, KeyError, NotPortedError) as e:
        ap.error(str(e))
    slots, max_len, page, n_req, prompt_lens, max_new = SMOKE_SIZES if args.smoke else FULL_SIZES
    if args.requests is not None:
        n_req = args.requests
    device = resolve_device(args.device)

    model = build(cfg, device=device, seed=0)
    print(f"serving {cfg.name} on {device}: {param_count(model) / 1e6:.1f}M params, "
          f"engine={args.engine}, telemetry agg={agg.strategy}")
    trace = PoissonLoadGen(rate=args.rate, prompt_lens=prompt_lens, max_new=max_new,
                           vocab_size=cfg.vocab_size, seed=args.seed).trace(n_req)

    session = trace_from_args(args)
    t0 = perf_counter()
    try:
        if args.engine == "continuous":
            eng = ContinuousEngine(model, num_slots=slots, max_len=max_len, page_size=page,
                                   agg=agg)
            results = eng.run_trace(trace)
        else:
            # the static engine has no arrival times: every request is
            # present up front
            eng = ServeEngine(model, batch_size=slots, max_len=max_len, agg=agg)
            results = eng.run([r for _, r in trace])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = perf_counter() - t0
    finally:
        session.finish()

    total_new = sum(len(r.tokens) for r in results)
    print(f"{n_req} requests, {total_new} tokens in {dt:.2f}s ({total_new / dt:.1f} tok/s)")
    if args.engine == "continuous":
        rep = latency_report(eng.latency_stats(), slo_ttft=2 * slots, slo_tpot=1.5)
        print("latency (scheduler-step units): "
              + ", ".join(f"{k}={v:.2f}" for k, v in rep.items()))
        print(f"paged KV peak: {eng.cache.peak_pages_in_use} pages "
              f"({eng.cache.peak_pages_in_use * page} tok) vs dense "
              f"{eng.cache.dense_equivalent_tokens} tok")
    print(f"telemetry (aggregated via {eng.aggregator}): {eng.telemetry}")
    for r in results[:3]:
        print(f"  rid={r.rid} -> {r.tokens[:8].tolist()}...")


if __name__ == "__main__":
    main()
