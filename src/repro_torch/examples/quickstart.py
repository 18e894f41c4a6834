"""Quickstart: FPISA in 60 seconds (counterpart of ``examples/quickstart.py``).

1. Encode a gradient tensor into switch-register integer planes.
2. Aggregate 8 workers three ways: exact float, bit-faithful FPISA-A (switch
   arrival semantics), and the production block-integer path (order-invariant).
3. Show the paper's headline numerics: tiny error, bounded overwrite events,
   bit-exact reproducibility for the production path.
4. Bucketed whole-tree aggregation, bit-identical to per leaf.

The production path honors the same shared knobs as every launcher
(``repro_torch.core.agg.add_agg_args``):
  --agg-backend {auto,torch,cuda}   encode/decode backend (cuda: K1/K2)
  --agg-chunk N                     stream the gradient in N-element chunks
  --bucket-bytes N                  bucketed whole-tree aggregation (step 4)

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import fpisa as F
from repro_torch.core import numerics as nx
from repro_torch.core.agg import AggConfig, Aggregator, add_agg_args, resolve_backend
from repro_torch.kernels import ops
from repro_torch.trace import add_trace_args
from repro_torch.trace import from_args as trace_from_args

W, N, BLOCK = 8, 1 << 16, 256


def block_aggregate(chunk: np.ndarray, backend: str, dev) -> torch.Tensor:
    """chunk: (W, M) with M % BLOCK == 0 -> aggregated (M,) float32."""
    s = nx.required_preshift(W)
    x = torch.from_numpy(chunk).to(dev)
    if backend == "cuda":
        # the fused single-pass kernels: local block max + the exact residual
        # shift to the cross-worker max, bit-identical to the block path
        mans, bmaxs = zip(*(ops.encode_align(x[w].reshape(-1, BLOCK)) for w in range(W)))
        bmax = torch.stack(bmaxs).amax(dim=0)
        man = torch.stack([nx.arshift(m, (bmax - bm)[:, None] + s)
                           for m, bm in zip(mans, bmaxs)])
        return ops.decode_fused(man.sum(0, dtype=torch.int32), bmax, s).reshape(-1)
    pe = F.encode(x.reshape(-1)).exp.reshape(W, chunk.shape[1])
    bmax = F.block_max_exponent(pe, BLOCK).amax(dim=0)  # "MAX across workers"
    man = torch.stack([F.block_encode(x[w], bmax, BLOCK, s) for w in range(W)])
    man_sum = man.sum(0, dtype=torch.int32)  # "integer SUM": associative, reproducible
    return F.block_decode(man_sum, bmax, BLOCK, s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_agg_args(ap)  # the same shared --agg-* flags every entry point uses
    add_trace_args(ap)  # the shared --trace-* flags (repro_torch.trace)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.set_defaults(bucket_bytes=1 << 16)  # step 4's whole-tree demo
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    backend = resolve_backend(args.agg_backend, dev)
    session = trace_from_args(args)  # spans from step 4's Aggregator calls

    rng = np.random.default_rng(0)
    grads = (rng.standard_normal((W, N)) * 0.01).astype(np.float32)

    # --- 1. the representation (paper Fig. 3) ---
    g0 = torch.from_numpy(grads[0]).to(dev)
    planes = F.encode(g0)
    print(f"FP32 value {grads[0, 0]:+.6f} -> exp={int(planes.exp[0])} "
          f"man={int(planes.man[0])} (two's-complement, 7 headroom bits)")
    assert torch.equal(F.renormalize(planes), g0)
    print("encode -> delayed-renormalize roundtrip: bit-exact")

    # --- 2. aggregation three ways ---
    exact = grads.astype(np.float64).sum(0)
    seq, stats = F.fpisa_sum_sequential(torch.from_numpy(grads).to(dev), return_stats=True)
    err = np.abs(seq.cpu().numpy().astype(np.float64) - exact)
    print(f"\nFPISA-A (switch arrival order): p50 err {np.quantile(err, 0.5):.2e}, "
          f"p99 {np.quantile(err, 0.99):.2e}, overwrites {int(stats['overwrite'])} "
          f"of {W * N} adds (paper: rare, <0.9%)")

    chunk = args.agg_chunk or N
    assert chunk % BLOCK == 0, "--agg-chunk must be a multiple of 256"
    out = torch.cat([block_aggregate(grads[:, lo:lo + chunk], backend, dev)
                     for lo in range(0, N, chunk)])
    err2 = np.abs(out.cpu().numpy().astype(np.float64) - exact)
    print(f"FPISA block-integer psum [{backend}"
          f"{', chunked' if args.agg_chunk else ''}]: "
          f"p99 err {np.quantile(err2, 0.99):.2e}")

    perm = rng.permutation(W)
    out2 = torch.cat([block_aggregate(grads[perm][:, lo:lo + chunk], backend, dev)
                      for lo in range(0, N, chunk)])
    print("permutation-invariant bit-exact:", bool(torch.equal(out, out2)),
          "(float sums are NOT — this is the production win)")

    # --- 4. bucketed whole-tree aggregation (what --bucket-bytes turns on) ---
    # The trainer aggregates a tree of ragged leaves. Bucketing flattens it
    # into fixed-size block-aligned wire buckets (a block never spans two
    # leaves), streamed double-buffered, bit-identical to per leaf
    # (core/bucketer.py).
    tree = {f"layer{i}": torch.from_numpy((rng.standard_normal(n) * 0.01).astype(np.float32))
            .to(dev) for i, n in enumerate((4096, 700, 13 * 37, 2048, 5))}

    def agg_tree(bucket_bytes: int):
        return Aggregator(AggConfig(strategy="fpisa", backend=args.agg_backend,
                                    bucket_bytes=bucket_bytes)).allreduce_tree(tree)

    per_leaf, bucketed = agg_tree(0), agg_tree(args.bucket_bytes)
    same = all(torch.equal(per_leaf[k].view(torch.int32), bucketed[k].view(torch.int32))
               for k in tree)
    print(f"\nbucketed tree aggregation ({args.bucket_bytes} B buckets) "
          f"bit-identical to per-leaf: {same}")
    session.finish()


if __name__ == "__main__":
    main()
