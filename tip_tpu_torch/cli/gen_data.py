"""CLI: synthesize training data from AMASS (twin of
tip_tpu/cli/gen_data.py; reference data-gen-and-viz-bullet-new.py:287-339 +
data-gen-new-scripts.bash).

  python -m tip_tpu_torch.cli.gen_data --src_dir <AMASS/subset> \
      --save_dir data/syn_X_v1 [--name_contains regex] [--n_proc 7] \
      [--seed 42] [--shard_index 0 --num_shards 1] [--device cpu]

Multi-host fan-out: run one process per host with
--shard_index/--num_shards; motions are partitioned by a stable hash of the
output name, so shards never collide, resume is idempotent, and the
per-motion RNG stream is independent of scheduling, sharding, or resume
order. ``--n_proc`` > 1 synthesizes in that many worker processes, started
with the ``spawn`` method (a CUDA context does not survive ``fork``). The
synthesis runs in float64 on ``cuda`` unless ``--device cpu`` is given.
"""

import argparse
import multiprocessing
import os
import re
import zlib
from concurrent.futures import ProcessPoolExecutor

import numpy as np


def _name_hash(save_path: str) -> int:
    return zlib.crc32(os.path.basename(save_path).encode())


def iter_jobs(src_dir, save_dir, name_contains, shard_index=0, num_shards=1):
    for d, _, files in os.walk(src_dir):
        for fn in files:
            if not fn.endswith("_poses.npz"):
                continue
            save_local = (d.rsplit("/", 1)[-1] + "_" + fn[:-10] + ".pkl"
                          ).replace(" ", "_")
            save_path = os.path.join(save_dir, save_local)
            if name_contains and not re.search(name_contains, save_path,
                                               re.IGNORECASE):
                continue
            if _name_hash(save_path) % num_shards != shard_index:
                continue
            if os.path.exists(save_path):      # idempotent resume
                continue
            yield os.path.join(d, fn), save_path


def run_one(src: str, dst: str, seed: int, device=None) -> int:
    """Synthesize one motion file; 1 if it was written. The RNG stream is
    derived from the output name: reproducible under any worker
    scheduling, sharding, or resume order."""
    from tip_tpu_torch.data_gen.amass_syn import synthesize_file
    rng = np.random.default_rng([seed, _name_hash(dst)])
    ok = synthesize_file(src, dst, rng=rng, device=device)
    if ok:
        print("wrote", dst)
    return int(ok)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--src_dir", required=True)
    ap.add_argument("--save_dir", required=True)
    ap.add_argument("--name_contains", default="")
    ap.add_argument("--n_proc", type=int, default=1)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--shard_index", type=int, default=0)
    ap.add_argument("--num_shards", type=int, default=1,
                    help="partition motions across hosts by output-name hash")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if not 0 <= args.shard_index < args.num_shards:
        ap.error(f"--shard_index {args.shard_index} is outside "
                 f"[0, {args.num_shards})")

    from tip_tpu_torch import resolve_device
    device = str(resolve_device(args.device))
    os.makedirs(args.save_dir, exist_ok=True)
    jobs = list(iter_jobs(args.src_dir, args.save_dir, args.name_contains,
                          args.shard_index, args.num_shards))
    print(f"{len(jobs)} motions to synthesize "
          f"(shard {args.shard_index}/{args.num_shards})")

    if args.n_proc > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(args.n_proc, mp_context=ctx) as ex:
            futures = [ex.submit(run_one, s, d, args.seed, device)
                       for s, d in jobs]
            results = [f.result() for f in futures]
    else:
        results = [run_one(s, d, args.seed, device) for s, d in jobs]
    count = int(np.sum(results))
    print("count", count)
    return count


if __name__ == "__main__":
    main()
