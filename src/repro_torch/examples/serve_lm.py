"""Serving example: greedy decode over a Poisson request trace with either
engine (counterpart of ``examples/serve_lm.py``): ``--engine static``
(lockstep batches, dense per-slot KV) or ``--engine continuous`` (continuous
batching over the paged KV cache). Both see the same load-generated
workload and aggregate their serving telemetry through the ``Aggregator``
facade the trainers use (the shared ``--agg-*`` flags).

The model is the reference's: internlm2-20b's smoke config at 4 layers x
128 wide with 8 heads and 2 KV heads (``--smoke``: 2 layers x 64, 4 heads),
its weights drawn from the seed.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--agg-strategy fpisa]
      PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu --smoke \
          --engine continuous
"""
import argparse
from time import perf_counter

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.core.agg import AggConfig, add_agg_args
from repro_torch.models.registry import build, param_count
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.loadgen import PoissonLoadGen, latency_report
from repro_torch.serve.scheduler import ContinuousEngine
from repro_torch.trace import add_trace_args
from repro_torch.trace import from_args as trace_from_args


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_agg_args(ap)  # the shared --agg-* flags (repro_torch.core.agg)
    add_trace_args(ap)  # the shared --trace-* flags (repro_torch.trace)
    ap.add_argument("--engine", choices=("static", "continuous"),
                    default="static", help="serving engine to demo")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny model + short trace")
    ap.add_argument("--requests", type=int, default=None,
                    help="trace length (default 8, smoke 6)")
    ap.add_argument("--rate", type=float, default=1.0,
                    help="Poisson arrival rate, requests per scheduler step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    try:
        agg = AggConfig.from_args(args)
    except ValueError as e:
        ap.error(str(e))
    device = resolve_device(args.device)

    cfg = get_smoke_config("internlm2-20b").with_(num_layers=4, d_model=128,
                                                  num_heads=8, num_kv_heads=2)
    slots, max_len, page = 4, 128, 16
    n_req, prompt_lens, max_new = 8, (4, 8, 16), (8, 16)
    if args.smoke:
        cfg = cfg.with_(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2)
        slots, max_len, page = 3, 32, 8
        n_req, prompt_lens, max_new = 6, (4, 8), (4, 8)
    if args.requests is not None:
        n_req = args.requests

    model = build(cfg, device=device, seed=0)
    print(f"serving {cfg.name}: {param_count(model)/1e6:.1f}M params, "
          f"engine={args.engine}, telemetry agg={agg.strategy}")

    trace = PoissonLoadGen(rate=args.rate, prompt_lens=prompt_lens, max_new=max_new,
                           vocab_size=cfg.vocab_size, seed=args.seed).trace(n_req)

    session = trace_from_args(args)
    t0 = perf_counter()
    if args.engine == "continuous":
        eng = ContinuousEngine(model, num_slots=slots, max_len=max_len, page_size=page,
                               agg=agg)
        results = eng.run_trace(trace)
    else:
        # the static engine serves the same requests as one closed queue (it
        # has no arrival times: every request is present up front)
        eng = ServeEngine(model, batch_size=slots, max_len=max_len, agg=agg)
        results = eng.run([r for _, r in trace])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = perf_counter() - t0
    session.finish()

    total_new = sum(len(r.tokens) for r in results)
    print(f"{n_req} requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new/dt:.1f} tok/s incl. compile)")
    if args.engine == "continuous":
        rep = latency_report(eng.latency_stats(), slo_ttft=2 * slots, slo_tpot=1.5)
        print("latency (scheduler-step units): " +
              ", ".join(f"{k}={v:.2f}" for k, v in rep.items()))
        print(f"paged KV peak: {eng.cache.peak_pages_in_use} pages "
              f"({eng.cache.peak_pages_in_use * page} tok) vs dense "
              f"{eng.cache.dense_equivalent_tokens} tok")
    print(f"telemetry (aggregated via {eng.aggregator}): {eng.telemetry}")
    for r in results[:3]:
        print(f"  rid={r.rid} -> {r.tokens[:8].tolist()}...")


if __name__ == "__main__":
    main()
