"""Render motions to GIF/PNG stick-figure animations, no PyBullet needed
(twin of tip_tpu/cli/render.py).

Counterpart of the reference's GUI viewing paths (offline_testing_simple.py
--render / viz_2_trajs..., render_funcs.py) built on the matplotlib
renderer (viz/skeleton_render.py). Two inputs:

  * --dump: an eval-harness raw-trajectory dump (evaluate(save_trajs_path=…),
    the reference's test-output-tmp.pkl artifact): renders predicted vs
    ground-truth skeletons for one motion;
  * --motion_pkl: a dataset/corpus pickle: renders its ground-truth
    trajectory alone (data QA).

The FK runs on ``cuda`` unless ``--device cpu`` is given; drawing needs
matplotlib and Pillow.

Examples:
  python -m tip_tpu_torch.cli.render --dump /tmp/trajs.pkl --index 3 \\
      --out m3.gif
  python -m tip_tpu_torch.cli.render --motion_pkl corpus_test/dance_0901.pkl \\
      --out dance.gif --stride 6
"""

import argparse
import pickle

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--dump", help="eval raw-trajectory dump (pkl)")
    src.add_argument("--motion_pkl", help="dataset pickle (gt only)")
    ap.add_argument("--index", type=int, default=0,
                    help="motion index inside --dump")
    ap.add_argument("--out", required=True,
                    help=".gif or a printf .png pattern (frame_%%04d.png)")
    ap.add_argument("--stride", type=int, default=4)
    ap.add_argument("--fps", type=int, default=15)
    ap.add_argument("--max_frames", type=int, default=0,
                    help="truncate the trajectory (0 = all)")
    ap.add_argument("--device", default=None,
                    help="torch device of the FK (default cuda)")
    args = ap.parse_args(argv)

    from tip_tpu_torch import resolve_device
    from tip_tpu_torch.ops import kinematics as kin
    from tip_tpu_torch.viz import skeleton_render as SR
    skel = kin.amass_skeleton(device=resolve_device(args.device))

    if args.dump:
        with open(args.dump, "rb") as fh:   # the eval harness's dump
            d = pickle.load(fh)
        qdq = np.asarray(d["ours_list"][args.index])
        gt = np.asarray(d["gt_list"][args.index])
        name = d.get("files", ["?"] * (args.index + 1))[args.index]
    else:
        with open(args.motion_pkl, "rb") as fh:   # a dataset pickle
            d = pickle.load(fh)
        qdq, gt, name = np.asarray(d["nimble_qdq"]), None, args.motion_pkl
    if args.max_frames:
        qdq = qdq[:args.max_frames]
        gt = None if gt is None else gt[:args.max_frames]

    n = SR.render_motion(skel, qdq, args.out, gt_qdq=gt,
                         stride=args.stride, fps=args.fps)
    print(f"rendered {n} frames of {name} -> {args.out}")
    return n


if __name__ == "__main__":
    main()
