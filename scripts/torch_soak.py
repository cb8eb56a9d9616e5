#!/usr/bin/env python3
"""Long-stream soak: 10+ minutes of 60 Hz streaming through the port's FULL
runner (twin of scripts/soak.py, through tip_tpu_torch only).

    python3 scripts/torch_soak.py [--frames 36000] [--chunk 3600]
        [--serving_mode recompute|kv_cache|kv_cache_rnn_carry]
        [--device cuda]

Backs the O(window)-memory claim: the carry is a fixed set of tensors, so a
36,000-frame stream must run in constant device memory with finite outputs
and a terrain region table that degrades gracefully when full (the cursor
clamps, the last slot is reused). tip_tpu's configuration (scripts/soak.py)
in the port's spelling: ModelConfig at full width with K1 and the plain
encoder layer loop, random weights from seed 0, the default TerrainConfig,
multi_sbp on; chunk i is make_stream(chunk, seed=i). A chunk's frames are
queued with no host sync; the root track comes back once a chunk.

Prints a progress line a chunk and one JSON line: soak.py's keys and values,
plus device memory allocated after chunk 1 and at the end and their
difference, the peak allocated over the run, every kernel's launches (and
launches a frame), and the card's name and power limit. ``ok`` is
soak.py's, and on the card also requires that device memory after chunk 1
grows by at most 1 MiB. Exits 1 unless ok. The core is
chip_smoke.full_soak, which chip_smoke.py's path N-soak also drives.
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
    ap.add_argument("--frames", type=int, default=36000)   # 10 min @ 60 Hz
    ap.add_argument("--chunk", type=int, default=3600)
    ap.add_argument("--serving_mode", default="recompute",
                    choices=["recompute", "kv_cache", "kv_cache_rnn_carry"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels), or cpu (the plain versions)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from tip_tpu_torch import resolve_device
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.ops import kinematics as kin
    dev = resolve_device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch_soak: no CUDA device; the port's kernels "
                           "run on a GPU (--device cpu runs the plain "
                           "versions)")
    card = None
    if dev.type == "cuda":
        cs.exact_math()
        from tip_tpu_torch.ops import _kernels as K
        K.build_all()
        card = cs.card_info()
        print(card, flush=True)
    cfg = cs.soak_config(args.serving_mode)
    model = M.TIPModel(cfg.base.model, device=dev,
                       generator=torch.Generator().manual_seed(0))
    res, _, _ = cs.full_soak(model, cfg, kin.amass_skeleton(device=dev),
                             cs.s_init_pose(), args.frames, args.chunk, dev,
                             log=lambda m: print(m, flush=True))
    res.update(device=args.device, card=card)
    print(json.dumps(res), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
