"""CLI: multi-stream pose-serving daemon (twin of tip_tpu/cli/serve.py).

Serves many live IMU clients from one card: each TCP client speaks the
imu_bridge wire protocol (42 ascii floats per frame, pre-calibrated) and
gets its predicted 114-d pose back as a jsonl line per 60 Hz tick, all
clients served by one batched StreamPool step (runtime/serving.py,
runtime/serve_daemon.py).

  python -m tip_tpu_torch.cli.serve --ckpt output/model-v1 --five_sbp \
      --with_acc_sum --capacity 64 [--port 27100] [--serving_mode kv_cache] \
      [--forward_impl fused] [--bf16] [--chunk 16] [--seconds 0] \
      [--device cpu]

``--ckpt`` takes what cli/evaluate.py's ``load_model`` takes: a checkpoint
directory of this package, tip_tpu's orbax checkpoint or a reference
``.pt`` state dict. The pool runs on ``cuda``
unless ``--device cpu`` is given (there the kernels' plain versions run).
"""

import argparse


def build_daemon(args, log=print):
    """The ServeDaemon of parsed arguments (its pool on the device they
    name), not yet running."""
    from tip_tpu_torch import constants as cst
    from tip_tpu_torch import resolve_device
    from tip_tpu_torch.cli.evaluate import load_model
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.runtime import calibration as cal_lib
    from tip_tpu_torch.runtime import runner as runner_lib
    from tip_tpu_torch.runtime.serve_daemon import ServeDaemon
    from tip_tpu_torch.runtime.serving import StreamPool

    device = resolve_device(args.device)
    n_sbps = 5 if args.five_sbp else 2
    model_cfg = M.ModelConfig(
        size_s=cst.state_dim(n_sbps), with_acc_sum=args.with_acc_sum,
        forward_impl=args.forward_impl,
        compute_dtype="bfloat16" if args.bf16 else None)
    model = load_model(args.ckpt, model_cfg, n_sbps, device)
    cfg = runner_lib.RunnerConfig(model=model_cfg, n_sbps=n_sbps,
                                  with_acc_sum=args.with_acc_sum,
                                  serving_mode=args.serving_mode,
                                  tail_impl=args.tail_impl)
    pool = StreamPool(model, cfg, capacity=args.capacity, device=device,
                      chunk=args.chunk)
    return ServeDaemon(pool, cal_lib.t_pose_init_state(), host=args.host,
                       port=args.port, log=log)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=27100)
    ap.add_argument("--capacity", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=None,
                    help="step the pool in sub-batches of this many streams "
                         "(must divide --capacity)")
    ap.add_argument("--five_sbp", action="store_true")
    ap.add_argument("--with_acc_sum", action="store_true")
    ap.add_argument("--serving_mode", default="recompute",
                    choices=["recompute", "kv_cache", "kv_cache_rnn_carry"])
    ap.add_argument("--forward_impl", default="plain",
                    choices=["plain", "fused"],
                    help="fused = the pool's whole-model kernel (K8 in the "
                         "KV-cache modes, K9 in recompute); plain = the "
                         "model as layers")
    ap.add_argument("--tail_impl", default="auto",
                    choices=["auto", "plain", "fused"],
                    help="fused = the decode and tail kernels K2, K3 (5-SBP "
                         "layouts only). auto (default) = fused on the card "
                         "with 5 SBPs, plain otherwise")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute (compute_dtype='bfloat16')")
    ap.add_argument("--seconds", type=float, default=0.0,
                    help="stop after N seconds (0 = until ^C)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    daemon = build_daemon(args)
    print(f"serving on {args.host}:{daemon.port} "
          f"(capacity {args.capacity}, mode {args.serving_mode})")
    daemon.run(seconds=args.seconds or None)


if __name__ == "__main__":
    main()
