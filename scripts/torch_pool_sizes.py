#!/usr/bin/env python3
"""tip_tpu's twelve throughput rows (bench_throughput.py:39-54) served by
the port's StreamPool on one GPU, in turn, in one process.

    python3 scripts/torch_pool_sizes.py [--rows N ...]   # default: all 12

Each row is a pool of 256 to 4,096 streams (f32 or bf16; recompute,
kv_cache or kv_cache_rnn_carry; the plain or the fused forward) over the
60 in-tree motions on chip_smoke.py's row schedule: every slot joins at
tick 0 but for four that join mid-session, one stream leaves and its slot
is handed out again, 80 checked ticks, so that every window fills and
slides, then 30 ticks timed alone. The model is ModelConfig() at full width
with random weights from seed 0. chip_smoke.run_pool_row drives a row and
holds it by (a) its launches (one launch a tick of each kernel the route
takes, chip_smoke.row_kernels), (b) eleven ticks, three after the slide,
against the plain versions of the tick's kernels from the same pool state,
and (c) four sentinel slots (0, B/2 - 1, B/2, B - 1) against single-stream
runs of their inputs from each stream's own first frame (on the f32 row
also their free-running trajectories against the single runner), with
chip_smoke.py's pool-path tolerances. A row's line gives the tick (synced,
the median of the 30 timed ticks, which run nothing of the checks), the
stream-frames a second, the launches a tick, the peak memory of the timed
ticks, the seconds to fill the pool, to rebuild it after a failed tick and
of _pool_masks, K8's or K9's scratch and shared memory at that size, the
worst differences of (b) and (c), and tip_tpu's figure on a TPU v5e as a
yardstick, labelled as the TPU's.

Each row's JSON line goes to stdout and to chiprun_out/pool_sizes.jsonl; a
summary line a row is printed last. Exits 1 if any row fails. This is not
the port's benchmark and writes no BENCHMARK.json.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

OUT = ROOT / "chiprun_out" / "pool_sizes.jsonl"


def summary_line(s):
    return (f"row {s['row']} ({s['streams']}, {s['compute_dtype']}, "
            f"{s['serving_mode']}, {s['forward']}): ok; tick "
            f"{s['tick_ms']:.3f} ms, {s['stream_frames_per_s'] / 1e3:.1f}k "
            f"stream-frames/s (TPU v5e's: {s['tpu_v5e_frames_s_yardstick']}), "
            f"{s['peak_mib']:.0f} MiB, fill {s['fill_s']:.1f} s, rebuild "
            f"{s['rebuild_s']:.1f} s, (b) y {s['worst_b']['y']:.2g}, (c) "
            f"{s['worst_c']:.2g}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, nargs="+",
                    default=[r[0] for r in cs.POOL_ROWS],
                    help="the rows of bench_throughput.py to serve, 1-12")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_pool_sizes: no CUDA device; the port's kernels run on "
              "a GPU", file=sys.stderr)
        return 1
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.ops import _kernels as K
    from tip_tpu_torch.ops import kinematics as kin
    cs.exact_math()
    card = cs.card_info()
    print(card, flush=True)
    t0 = time.perf_counter()
    K.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    state_dict = M.TIPModel(M.ModelConfig(), device=dev,
                            generator=torch.Generator().manual_seed(0)
                            ).state_dict()
    motions = cs.load_motions()
    skel = kin.amass_skeleton(device=dev)
    OUT.parent.mkdir(exist_ok=True)
    lines = []
    with open(OUT, "w") as f:
        for row, B, dtype, mode, forward in cs.POOL_ROWS:
            if row not in args.rows:
                continue
            try:
                s = cs.run_pool_row(row, B, dtype, mode, forward, state_dict,
                                    skel, dev, motions)
            except Exception as e:          # noqa: BLE001
                first = (str(e).splitlines() or [""])[0]
                lines.append(f"row {row} ({B}, {dtype}, {mode}, {forward}): "
                             f"FAILED; {type(e).__name__}: {first}")
                print(lines[-1], flush=True)
                torch.cuda.synchronize()
                continue
            s["card"] = card
            line = json.dumps({"pool_row": s})
            print(line, flush=True)
            f.write(line + "\n")
            f.flush()
            lines.append(summary_line(s))
    print(f"{card}; {time.perf_counter() - t0:.1f} s", flush=True)
    print("\n".join(lines), flush=True)
    return 0 if all(": ok;" in ln for ln in lines) and lines else 1


if __name__ == "__main__":
    sys.exit(main())
