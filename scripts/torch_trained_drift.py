#!/usr/bin/env python3
"""How far the port's other routes lie from its float64 recompute run with
the trained weights (ROADMAP A3a, C4), on the CPU.

    python3 scripts/torch_trained_drift.py

Reads the flagship checkpoint from this clone's git history into a
temporary directory (tests/trained_checkpoint.py), runs tip_tpu's and the
port's run_offline in float64 over 300 frames of the in-tree motion, and
prints one JSON object: the float64 port against tip_tpu; the port's
float32 recompute run, K4's plain version with bf16 packing and the two
KV-cache modes (float64, the rows after the window slid) against the
float64 recompute run (max |diff| of the states and their mean joint angle
error); and the decode's smallest Shepperd margins over the run
(scripts/torch_decode_ties.py's ``margins``). Exits 1 where git or the
commit is absent.
"""

import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests"), str(ROOT / "scripts")]

import conftest  # noqa: E402,F401  the tests' JAX settings (CPU, x64)
import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_decode_ties as ties  # noqa: E402
import trained_checkpoint as TC  # noqa: E402
from tip_tpu_torch.models import tip_model as TM  # noqa: E402
from tip_tpu_torch.ops import fused_tail as FT  # noqa: E402
from tip_tpu_torch.ops import kinematics as tkin  # noqa: E402
from tip_tpu_torch.ops import metrics  # noqa: E402
from tip_tpu_torch.runtime import runner as TR  # noqa: E402


def decode_margins(model, cfg_r, skel, s_init, imu):
    """The decode's Shepperd margins over the run: the filtered outputs
    each decode takes, recorded."""
    real, seen = FT.decode_fused, []

    def recording(*a, **kw):
        o = real(*a, **kw)
        seen.append(o.y_f.detach().clone())
        return o
    FT.decode_fused = recording
    try:
        TR.run_offline(model, cfg_r, skel, s_init, imu, device="cpu")
    finally:
        FT.decode_fused = real
    return ties.margins(torch.stack(seen))


def main():
    reason = TC.missing()
    if reason:
        print(f"torch_trained_drift: {reason}", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        cfg, params = TC.load_trained(Path(tmp))
    j_out, t_out = TC.run_both(cfg, params)
    imu, s_init = TC.load_motion()
    sd = TM.params_from_jax(jax.tree_util.tree_map(
        lambda p: p.astype(np.float64), params))
    ref = torch.as_tensor(t_out[0])
    skel = tkin.amass_skeleton(dtype=torch.float64)
    slide = 5 + 40 + 1                   # first row after the window slid
    out = {"frames": TC.N_FRAMES, "f64_port_vs_tip_tpu": {
        n: float(np.abs(t - j).max())
        for n, t, j in zip(("s_traj", "c_traj", "viz"), t_out, j_out)}}

    def against_ref(name, cfg_r, dtype, rows=slice(None)):
        model = TM.TIPModel(cfg_r.model, device="cpu", dtype=dtype)
        model.load_state_dict({k: v.to(dtype) for k, v in sd.items()})
        s = TR.run_offline(model, cfg_r, tkin.amass_skeleton(dtype=dtype),
                           s_init, imu, device="cpu")[0].double()
        a, b = (tkin.our_pose_to_bullet(x[rows]) for x in (s, ref))
        out[name] = {"max_abs_diff": float((s - ref)[rows].abs().max()),
                     "joint_angle_err_deg": float(metrics.loss_angle(b, a)),
                     "rows": f"{rows.start or 0}:{rows.stop or TC.N_FRAMES}"}

    pc = TC.port_config(cfg)
    against_ref("f32_recompute", TR.RunnerConfig(model=pc), torch.float32)
    fused = TM.ModelConfig(**{**vars(pc), "forward_impl": "fused"})
    against_ref("k4_plain_bf16_packing", TR.RunnerConfig(model=fused),
                torch.float32)
    for mode in ("kv_cache", "kv_cache_rnn_carry"):
        against_ref(f"{mode}_f64_after_slide",
                    TR.RunnerConfig(model=pc, serving_mode=mode),
                    torch.float64, slice(slide, None))
    model = TM.TIPModel(pc, device="cpu", dtype=torch.float64)
    model.load_state_dict(sd)
    gap = decode_margins(model, TR.RunnerConfig(model=pc), skel, s_init, imu)
    low = gap.flatten().topk(5, largest=False).values
    out["decode_margins"] = {
        "smallest": [float(v) for v in low],
        "below_1e-4": int((gap < 1e-4).sum()),
        "below_1e-6": int((gap < 1e-6).sum()), "entries": gap.numel()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
