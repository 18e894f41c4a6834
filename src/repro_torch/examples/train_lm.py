"""End-to-end driver: train a ~100M-parameter LM with FPISA gradient
aggregation, checkpointing and automatic restart (counterpart of
``examples/train_lm.py``).

Defaults: the ~100M model, 300 steps. ``--smoke`` trains the reduced
qwen1.5-0.5b config instead. ``--fault-plan`` / ``--num-hosts`` route the
run through the elastic controller (``repro_torch.runtime.controller``).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]
      PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu --smoke
"""
import argparse
import os
import tempfile

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.agg import AggConfig, add_agg_args
from repro_torch.launch.train import train_loop
from repro_torch.trace import add_trace_args
from repro_torch.trace import from_args as trace_from_args


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny smoke-size config instead of the ~100M model")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    add_agg_args(ap)  # the shared --agg-* flags (repro_torch.core.agg)
    add_trace_args(ap)  # the shared --trace-* flags (repro_torch.trace)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default fpisa_train_lm (normal path) or fpisa_train_lm_fault "
                         "(--fault-plan path: the elastic controller resets its "
                         "checkpoint dir at start, so the two paths must not share "
                         "one), under the temporary directory")
    ap.add_argument("--fault-plan", default="",
                    help="inject failures and recover elastically, e.g. 'kill:2@40' "
                         "kills host 2 at step 40 (repro_torch/runtime/controller.py)")
    ap.add_argument("--num-hosts", type=int, default=None,
                    help="logical worker count for the controller path "
                         "(default: one per rank)")
    args = ap.parse_args(argv)

    if args.smoke:
        cfg = get_smoke_config("qwen1.5-0.5b")
    else:
        # ~100M-param qwen-family config (20 layers x 640 wide, 32k vocab)
        cfg = get_config("qwen1.5-0.5b").with_(
            name="qwen-100m", num_layers=20, d_model=640, num_heads=10,
            num_kv_heads=10, d_ff=1792, vocab_size=32768,
            param_dtype="float32", activation_dtype="float32",
            attn_q_chunk=256, learning_rate=3e-4,
        )
    try:
        agg = AggConfig.from_args(args)
    except ValueError as e:
        ap.error(str(e))
    device = resolve_device(args.device)
    session = trace_from_args(args)
    try:
        _run(ap, args, cfg, agg, device)
    finally:
        session.finish()


def _run(ap, args, cfg, agg, device):
    tmp = tempfile.gettempdir()
    if args.fault_plan or args.num_hosts:
        if agg.chunk_elems:
            ap.error("--agg-chunk is not supported on the elastic controller "
                     "path (stacked aggregation; use --bucket-bytes instead)")
        from repro_torch.runtime.controller import run_controller

        summary = run_controller(
            cfg, steps=args.steps, global_batch=8, seq_len=256, agg=agg,
            num_hosts=args.num_hosts,
            ckpt_dir=args.ckpt_dir or os.path.join(tmp, "fpisa_train_lm_fault"),
            fault_plan=args.fault_plan, device=device)
        hist = summary["history"]
        print(f"final loss {hist[-1]:.4f} (from {hist[0]:.4f}); "
              f"{len(summary['recoveries'])} recoveries, "
              f"switch slots reclaimed: "
              f"{sum(r['reclaimed'] for r in summary['recoveries'])}")
        return
    _, _, hist = train_loop(
        cfg, steps=args.steps, global_batch=8, seq_len=64 if args.smoke else 256,
        agg=agg, device=device,
        ckpt_dir=args.ckpt_dir or os.path.join(
            tmp, "fpisa_train_lm_smoke" if args.smoke else "fpisa_train_lm"),
        ckpt_every=50, log_every=10)
    print(f"final loss {hist[-1]:.4f} (from {hist[0]:.4f}); "
          f"resume supported via --ckpt-dir (re-run to continue)")


if __name__ == "__main__":
    main()
