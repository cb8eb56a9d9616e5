#!/usr/bin/env python3
"""Near-ties of the decode's Shepperd branch on pool path J.

    python3 scripts/torch_decode_ties.py [--device cpu|cuda] [--ticks 46]

The decode (ops/fused_tail.py) turns each joint's two 6D columns into a
matrix (both normalised, not orthogonalised, as tip_tpu does) and that
matrix into a quaternion by Shepperd's method, which keeps the candidate
built from the largest of four diagonal sums. For a matrix that is no
rotation, as a random model gives, the four candidates are different
quaternions, so where the two largest sums nearly tie a change of the
model output smaller than their margin turns the joint. This drives
chip_smoke.py's pool path J (recompute, fused, f32) over the in-tree
motions for the first ticks with the same random weights, records the
filtered output each decode takes, and prints the smallest margins by
(tick, slot, joint). On the CPU the kernels' plain versions run.
"""

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tip_tpu_torch.models import tip_model as M  # noqa: E402
from tip_tpu_torch.ops import fused_tail as FT  # noqa: E402
from tip_tpu_torch.ops import kinematics as kin  # noqa: E402
from tip_tpu_torch.ops import rotations as rot  # noqa: E402
from tip_tpu_torch.runtime import runner as R  # noqa: E402
from tip_tpu_torch.runtime.serving import StreamPool  # noqa: E402


def margins(y_f):
    """(..., state) filtered outputs -> (..., 18) gap between the two
    largest of Shepperd's four sums for each joint's matrix."""
    m = rot.sixd_to_matrix(y_f[..., :108].reshape(y_f.shape[:-1] + (18, 6)))
    d0, d1, d2 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    t = torch.stack([1 + d0 + d1 + d2, 1 + d0 - d1 - d2, 1 - d0 + d1 - d2,
                     1 - d0 - d1 + d2], dim=-1)
    top = t.topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--ticks", type=int, default=cs.GROW_ROWS)
    args = ap.parse_args()
    dev = torch.device(args.device)
    sd = M.TIPModel(M.ModelConfig(), device=dev,
                    generator=torch.Generator().manual_seed(0)).state_dict()
    batch, active, events, s_inits = cs.pool_schedule(args.ticks)
    cfg = R.RunnerConfig(model=M.ModelConfig(forward_impl="fused",
                                             compute_dtype="float32"))
    model = M.TIPModel(cfg.model, device=dev)
    model.load_state_dict(sd)
    pool = StreamPool(model, cfg, kin.amass_skeleton(device=dev),
                      capacity=cs.POOL_CAPACITY, device=dev)
    real, seen = FT.decode_fused, []

    def recording(*a, **kw):
        out = real(*a, **kw)
        seen.append(out.y_f.detach().clone())
        return out
    FT.decode_fused = recording
    try:
        for t in range(args.ticks):
            for kind, slot, motion in events.get(t, ()):
                if kind == "remove":
                    pool.remove_stream(slot)
                else:
                    pool.add_stream(s_inits[motion])
            with torch.no_grad():
                pool.step(batch[t].to(dev))
    finally:
        FT.decode_fused = real
    gap = margins(torch.stack(seen)).cpu()          # (ticks, slots, 18)
    gap[~active[:args.ticks].bool()] = float("inf")
    flat = gap.flatten().topk(5, largest=False)
    for v, i in zip(flat.values.tolist(), flat.indices.tolist()):
        t, rest = divmod(i, gap.shape[1] * 18)
        print(f"tick {t}, slot {rest // 18}, joint {rest % 18}: margin "
              f"{v:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
