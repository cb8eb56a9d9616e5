"""CLI: offline evaluation (twin of tip_tpu/cli/evaluate.py; reference
offline_testing_simple.py + README step 5).

  python -m tip_tpu_torch.cli.evaluate --ckpt output/model-v1 \
      --name_contains "dipimu_s_09 dipimu_s_10" --test_len 30000 \
      --with_acc_sum --five_sbp [--full_runner] [--data_root data]

``--ckpt`` takes a checkpoint directory of this package (cli/train.py's,
cli/import_torch_ckpt.py's), tip_tpu's orbax checkpoint (a step directory
or a manager's directory of numbered steps, read with
utils/orbax_read.py: no orbax or tensorstore, the system's
``libzstd.so.1``), their parameters only, or a reference ``.pt`` state
dict. The run is on ``cuda`` unless ``--device cpu`` is given (there the
kernels' plain versions run). ``--viz_compare`` replays each motion in the
PyBullet viewer (needs the pybullet wheel), ``--render_gifs`` writes a
stick-figure GIF a motion (needs matplotlib and Pillow).
"""

import argparse
import json
import os

# reference test-data directory list (offline_testing_simple.py:307-314)
TEST_DIRS_V0 = [
    "syn_AMASS_CMU_v0", "syn_Eyes_Japan_Dataset_v0", "syn_KIT_v0",
    "syn_HUMAN4D_v0", "syn_ACCAD_v0", "syn_DFaust_67_v0", "syn_HumanEva_v0",
    "syn_MPI_Limits_v0", "syn_MPI_mosh_v0", "syn_SFU_v0",
    "syn_Transitions_mocap_v0", "preprocessed_DIP_IMU_v0",
    "preprocessed_TotalCapture_v0", "syn_TotalCapture_v0", "syn_DanceDB_v0",
]


def load_model(ckpt: str, model_cfg, n_sbps: int, device):
    """A TIPModel on ``device`` with the weights of ``ckpt``: a reference
    ``.pt`` state dict, or a checkpoint directory of this package or
    tip_tpu's orbax checkpoint (its parameters only,
    ``train.restore_checkpoint``)."""
    import torch
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.train import train as train_lib
    if ckpt.endswith(".pt"):
        sd = torch.load(ckpt, map_location="cpu", weights_only=True)
        model = M.TIPModel(model_cfg, device=device)
        model.load_state_dict(M.params_from_torch_state_dict(sd, model_cfg))
        return model
    cfg_t = train_lib.TrainConfig(model=model_cfg, n_sbps=n_sbps)
    model = train_lib.restore_checkpoint(ckpt, cfg_t, params_only=True,
                                         device=device).model
    model.requires_grad_(False)
    return model


def make_viz_hook(args, n_sbps: int, device):
    """The harness's per-motion hook of ``--viz_compare`` (the PyBullet
    viewer) and ``--render_gifs`` (a GIF a motion), chained as tip_tpu's
    are, or None. The viewer is made here, before the first motion."""
    import numpy as np
    import torch

    from tip_tpu_torch.ops import kinematics as kin
    from tip_tpu_torch.runtime import terrain as terrain_lib

    hooks = []
    if args.viz_compare:
        from tip_tpu_torch.viz import pybullet_viz, urdf_export
        viewer = pybullet_viz.Viewer(urdf_export.default_urdf_path(),
                                     n_markers=2 * n_sbps, compare_gt=True)

        def to_bullet(qdq):
            return kin.our_pose_to_bullet(
                torch.as_tensor(np.asarray(qdq), dtype=torch.float32)).numpy()

        def compare(f, gt, pred, info):
            heights = (terrain_lib.height_field(info["terrain"]).cpu().numpy()
                       if "terrain" in info else None)
            gsz = (info["terrain_cfg"].grid_size if "terrain_cfg" in info
                   else 0.1)
            pybullet_viz.replay_compare(
                viewer, to_bullet(pred), to_bullet(gt),
                viz_locs=info.get("viz_locs"), heights=heights,
                grid_size=gsz)
        hooks.append(compare)
    if args.render_gifs:
        from tip_tpu_torch.viz import skeleton_render as SR
        os.makedirs(args.render_gifs, exist_ok=True)
        rskel = kin.amass_skeleton(device=device)

        def gif(f, gt, pred, info):
            name = os.path.splitext(os.path.basename(f))[0] + ".gif"
            SR.render_motion(
                rskel, np.asarray(pred), os.path.join(args.render_gifs, name),
                gt_qdq=np.asarray(gt), viz_locs=info.get("viz_locs"),
                terrain_state=info.get("terrain"),
                terrain_cfg=info.get("terrain_cfg"),
                stride=args.render_stride)
        hooks.append(gif)
    if not hooks:
        return None

    def viz_hook(f, gt, pred, info):
        for hook in hooks:
            hook(f, gt, pred, info)
    return viz_hook


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", required=True,
                    help="checkpoint dir of this package, tip_tpu's orbax "
                         "checkpoint dir (or .pt torch state_dict)")
    ap.add_argument("--name_contains", default="")
    ap.add_argument("--data_root", default="data")
    ap.add_argument("--tag", default="v0")
    ap.add_argument("--test_len", type=int, default=600)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--five_sbp", action="store_true")
    ap.add_argument("--with_acc_sum", action="store_true")
    ap.add_argument("--full_runner", action="store_true")
    ap.add_argument("--multi_sbp", action="store_true",
                    help="SBP-conditioned IK history feedback + pelvis "
                         "terrain updates (needs --full_runner; reference "
                         "MULTI_SBP_CORRECTION)")
    ap.add_argument("--map_bound", type=float, default=None,
                    help="terrain grid half-extent in metres for "
                         "--full_runner (default: the reference's +-5 m, "
                         "constants.MAP_BOUND; raise for corpora that "
                         "wander beyond it)")
    ap.add_argument("--save_trajs", default=None,
                    help="dump raw gt/pred trajectories to this pkl "
                         "(reference test-output-tmp.pkl)")
    ap.add_argument("--metrics", default=None,
                    help="structured jsonl results (per-motion + summary)")
    ap.add_argument("--viz_compare", action="store_true",
                    help="replay each motion in the PyBullet viewer: ours vs "
                         "GT + SBP markers + terrain (needs the pybullet "
                         "wheel; reference --compare_gt viz)")
    ap.add_argument("--render_gifs", default=None, metavar="DIR",
                    help="write one ours-vs-GT stick-figure GIF per motion "
                         "into DIR (matplotlib renderer, no pybullet; "
                         "includes SBP markers and, with --full_runner, the "
                         "final terrain map)")
    ap.add_argument("--render_stride", type=int, default=4)
    ap.add_argument("--extras", action="store_true",
                    help="also report capability metrics beyond the "
                         "reference's 8: per-channel SBP contact-flag "
                         "precision/recall vs the pickles' labels and (with "
                         "--full_runner) terrain-reconstruction quality "
                         "(eval_terrain.py)")
    ap.add_argument("--serving_mode", default="recompute",
                    choices=["recompute", "kv_cache", "kv_cache_rnn_carry"],
                    help="run the metric protocol under a KV-cached serving "
                         "mode; default is the reference-parity recompute "
                         "path")
    ap.add_argument("--forward_impl", default="xla",
                    choices=["xla", "fused"],
                    help="fused = the whole-model kernel K4 (recompute) or "
                         "the whole cached step K7 (bf16 weights); xla = "
                         "the model as layers")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions)")
    args = ap.parse_args(argv)

    from tip_tpu_torch import constants as cst
    from tip_tpu_torch import eval_harness as H
    from tip_tpu_torch import resolve_device
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.runtime import runner as runner_lib

    device = resolve_device(args.device)
    n_sbps = 5 if args.five_sbp else 2
    model_cfg = M.ModelConfig(
        size_s=cst.state_dim(n_sbps), with_acc_sum=args.with_acc_sum,
        forward_impl="fused" if args.forward_impl == "fused" else "plain")
    model = load_model(args.ckpt, model_cfg, n_sbps, device)

    cfg = H.EvalConfig(
        runner=runner_lib.RunnerConfig(model=model_cfg, n_sbps=n_sbps,
                                       with_acc_sum=args.with_acc_sum,
                                       serving_mode=args.serving_mode),
        use_full_runner=args.full_runner, multi_sbp=args.multi_sbp,
        test_len=args.test_len, seed=args.seed,
        **({"terrain_map_bound": args.map_bound}
           if args.map_bound is not None else {}))

    dirs = [d.replace("v0", args.tag) for d in TEST_DIRS_V0]
    files = H.collect_test_files(args.data_root, dirs,
                                 args.name_contains.split())
    print(f"{len(files)} candidate motions")

    viz_hook = make_viz_hook(args, n_sbps, device)

    mw = None
    if args.metrics:
        from tip_tpu_torch.utils.observability import MetricsWriter
        mw = MetricsWriter(args.metrics)

    extras = {} if args.extras else None
    per_motion, means, maxima = H.evaluate(model, cfg, files,
                                           save_trajs_path=args.save_trajs,
                                           viz_hook=viz_hook,
                                           metrics_writer=mw,
                                           extras_out=extras, device=device)
    if mw is not None:
        if extras:
            mw.write(kind="extras", **extras)
        mw.close()

    print(json.dumps({"means": means}, indent=2))
    if extras:
        print(json.dumps({"extras": extras}, indent=2))
    for k, (v, f) in maxima.items():
        print(f"max {k}: {v:.4f}  ({f})")
    return per_motion, means, maxima


if __name__ == "__main__":
    main()
