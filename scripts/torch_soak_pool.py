#!/usr/bin/env python3
"""Serving-pool churn soak: the port's StreamPool under continuous add and
remove (twin of scripts/soak_pool.py, through tip_tpu_torch only).

    python3 scripts/torch_soak_pool.py [--ticks 3000] [--capacity 64]
        [--serving_mode kv_cache_rnn_carry] [--forward_impl fused]
        [--block_each_tick] [--device_time_window W] [--device cuda]

ModelConfig(compute_dtype="bfloat16") at full width, random weights from
seed 0, as tip_tpu's script. Half the slots hold a stream from the start;
every 8 ticks a random stream other than the sentinel leaves (while more
than 4 are active) and a new one joins. Properties held:

  * isolation: the sentinel (slot 0, never churned) is compared tick by
    tick with a second, churn-free pool fed the same frames and ticks, up
    to the injected failure: the batched kernels' rows are independent, so
    the two agree within 1e-4 (tip_tpu's limit) however the slots around
    the sentinel come and go;
  * recovery: at ticks // 2 the tick fails as the port's can, after it
    wrote the pool's state in place: the injected step fills every floating
    tensor of the carry, the cache rings included, with NaN and raises.
    StreamPool.step must rebuild the pool (the active streams restart), the
    rebuilt state must be finite, and no later output may read the
    poisoned state;
  * every active slot's output finite at every tick; host RSS (from
    /proc/self/statm, not the high-water mark) and the device memory
    allocated after warm-up and at the end, and their growth.

--block_each_tick syncs every tick and records the per-tick latency
(p50/p99); --device_time_window W times windows of W ticks queued without a
sync, after the injection, and records wall / W. Prints progress lines and
one JSON line; exits 1 unless ok. The core is chip_smoke.soak, which
chip_smoke.py's churn run also drives.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ticks", type=int, default=3000)
    ap.add_argument("--capacity", type=int, default=64)
    ap.add_argument("--serving_mode", default="kv_cache_rnn_carry",
                    choices=["recompute", "kv_cache", "kv_cache_rnn_carry"])
    ap.add_argument("--forward_impl", default="fused",
                    choices=["plain", "fused"])
    ap.add_argument("--block_each_tick", action="store_true",
                    help="sync every tick and record its latency (p50/p99): "
                         "whether add, remove and the rebuild stall ticks")
    ap.add_argument("--device_time_window", type=int, default=0,
                    metavar="W",
                    help="after the injection, queue W ticks without a sync "
                         "and record wall / W per window")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels), or cpu (the plain versions)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("torch_soak_pool: no CUDA device; the port's kernels run on a "
              "GPU (--device cpu runs the plain versions)", file=sys.stderr)
        return 1
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.ops import kinematics as kin
    from tip_tpu_torch.runtime import runner as R
    from tip_tpu_torch.runtime.serving import StreamPool
    if dev.type == "cuda":
        cs.exact_math()
        from tip_tpu_torch.ops import _kernels as K
        K.build_all()
        print(cs.card_info(), flush=True)
    cfg = R.RunnerConfig(
        model=M.ModelConfig(compute_dtype="bfloat16",
                            forward_impl=args.forward_impl),
        serving_mode=args.serving_mode)
    model = M.TIPModel(cfg.model, device=dev,
                       generator=torch.Generator().manual_seed(0))
    skel = kin.amass_skeleton(device=dev)
    pool = StreamPool(model, cfg, skel, capacity=args.capacity, device=dev)
    ref_pool = StreamPool(model, cfg, skel, capacity=args.capacity,
                          device=dev)
    with torch.no_grad():
        res = cs.soak(pool, ref_pool, args.ticks, cs.make_stream(600),
                      cs.s_init_pose(), block_each_tick=args.block_each_tick,
                      device_time_window=args.device_time_window,
                      log=lambda m: print(m, flush=True))
    res["device"] = args.device
    print(json.dumps(res), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
