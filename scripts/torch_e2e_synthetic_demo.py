#!/usr/bin/env python3
"""End-to-end slice on the card: synthesize -> pack -> train -> evaluate
(twin of scripts/e2e_synthetic_demo.py, through tip_tpu_torch only).

Generates a family of synthetic SMPL motions (the same numpy stream as
tip_tpu's script, default_rng(7)), synthesizes their IMU streams on the
device (data_gen/amass_syn.py), packs them (data_gen/combine.py), trains
the *full-size* paper-config model (train.train_loop: K1, K10, K11 and K12
on the card) for a few epochs, then evaluates trained against untrained
parameters with the offline harness on held-out motions (K1, K2, K3 and,
under the default encoder_impl="auto", K11). Metrics must improve: the
trained pose error below 0.8 of the untrained one.

  python3 scripts/torch_e2e_synthetic_demo.py [--epochs 20] [--n_train 16]
      [--n_test 4] [--out output/tip_e2e] [--serving_mode recompute]
      [--device cuda]

Prints the untrained and trained means, the training time and the launches
of every kernel that training and each evaluation ran (and one JSON line
with all of them), then the final ``OK:`` line. ``run`` takes the model
configuration (tip_tpu's full-size one by default).
"""

import argparse
import json
import os
import pickle
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def make_motion(rng, T=420, fps=120.0):
    from tip_tpu_torch.data_gen import smpl

    t = np.arange(T) / fps
    poses = np.zeros((T, 24, 3))
    poses[:, 0] = [1.20919958, 1.20919958, 1.20919958]
    # randomized multi-joint swing field
    for j in (1, 2, 4, 5, 7, 8, 3, 6, 12, 15, 16, 17, 18, 19):
        amp = rng.uniform(0.05, 0.45)
        f = rng.uniform(0.3, 1.2)
        ph = rng.uniform(0, 2 * np.pi)
        ax = rng.normal(size=3)
        ax /= np.linalg.norm(ax)
        poses[:, j] = np.outer(amp * np.sin(2 * np.pi * f * t + ph), ax)
    trans = np.zeros((T, 3))
    trans[:, 2] = 0.95 + 0.03 * np.sin(2 * np.pi * 0.9 * t)
    trans[:, 0] = rng.uniform(-0.5, 0.5) * t
    trans[:, 1] = rng.uniform(-0.3, 0.3) * t
    return smpl.SmplMotion(poses=poses, trans=trans, fps=fps)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--n_train", type=int, default=16)
    ap.add_argument("--n_test", type=int, default=4)
    ap.add_argument("--out", default=str(ROOT / "output" / "tip_e2e"))
    ap.add_argument("--serving_mode", default="recompute",
                    choices=["recompute", "kv_cache", "kv_cache_rnn_carry"],
                    help="evaluate the trained model with this runner "
                         "serving mode")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels), or cpu (the plain versions)")
    return ap.parse_args(argv)


def launches_since(K):
    """The kernels' launches since the counters were last set to 0."""
    return {k: n for k, n in sorted(K.launch_counts.items()) if n}


def run(args, model_cfg=None):
    """Synthesis, packing, training and both evaluations of a model of
    ``model_cfg`` (default: ModelConfig(), the full size); prints the means
    and the launches and returns the JSON line's dict."""
    import torch

    from tip_tpu_torch import eval_harness as H
    from tip_tpu_torch import resolve_device
    from tip_tpu_torch.data_gen import amass_syn
    from tip_tpu_torch.data_gen.combine import combine
    from tip_tpu_torch.models.tip_model import ModelConfig
    from tip_tpu_torch.ops import _kernels as K
    from tip_tpu_torch.runtime import runner as runner_lib
    from tip_tpu_torch.train import data as data_lib
    from tip_tpu_torch.train import train as train_lib

    dev = resolve_device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch_e2e_synthetic_demo: no CUDA device; the "
                           "port's kernels run on a GPU (--device cpu runs "
                           "the plain versions)")
    card = None
    if dev.type == "cuda":
        import chip_smoke as cs
        cs.exact_math()
        K.build_all()
        card = cs.card_info()
        print(card, flush=True)

    os.makedirs(args.out, exist_ok=True)
    train_dir = os.path.join(args.out, "syn_DEMO_v1")
    test_dir = os.path.join(args.out, "syn_DEMO_test_v1")
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(test_dir, exist_ok=True)

    rng = np.random.default_rng(7)
    t0 = time.time()
    for i in range(args.n_train + args.n_test):
        d = train_dir if i < args.n_train else test_dir
        path = os.path.join(d, f"motion_{i:02d}.pkl")
        if os.path.exists(path):
            continue
        payload = amass_syn.synthesize(make_motion(rng), rng=rng, device=dev)
        with open(path, "wb") as f:
            pickle.dump(payload, f)
    synth_s = time.time() - t0
    print(f"synthesized {args.n_train + args.n_test} motions "
          f"in {synth_s:.1f}s")

    prefix = os.path.join(args.out, "train_demo")
    if not os.path.exists(prefix + "_imu.npy"):
        combine([train_dir], [1], prefix, seed=0)

    ds = data_lib.PackedDataset.load(prefix + "_imu.npy", prefix + "_s.npy",
                                     prefix + "_info.npy")

    model_cfg = model_cfg or ModelConfig()
    cfg = train_lib.TrainConfig(model=model_cfg, epochs=args.epochs,
                                log_interval=20)
    untrained = train_lib.init_state(cfg, dev).model

    K.reset_launch_counts()
    t0 = time.time()
    state = train_lib.train_loop(
        cfg, ds, ckpt_dir=os.path.join(args.out, "ckpt"), device=dev,
        log_fn=lambda r: print(json.dumps(r)))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    train_s = time.time() - t0
    launches = {"train": launches_since(K)}
    print(f"trained {args.epochs} epochs in {train_s:.1f}s")

    eval_cfg = H.EvalConfig(
        runner=runner_lib.RunnerConfig(model=model_cfg,
                                       serving_mode=args.serving_mode),
        test_len=400, max_motions_per_cat=args.n_test)
    files = [os.path.join(test_dir, f) for f in sorted(os.listdir(test_dir))]

    means, eval_s = {}, {}
    for name, model in (("untrained", untrained), ("trained", state.model)):
        K.reset_launch_counts()
        t0 = time.time()
        with torch.no_grad():
            _, means[name], _ = H.evaluate(model, eval_cfg, files,
                                           log=lambda *a: None, device=dev)
        eval_s[name] = time.time() - t0
        launches[f"eval_{name}"] = launches_since(K)
    print("untrained:", json.dumps(means["untrained"], indent=1))
    print("trained:  ", json.dumps(means["trained"], indent=1))
    print("kernel launches:", json.dumps(launches))
    res = {
        "metric": "e2e_synthetic_demo", "device": args.device, "card": card,
        "epochs": args.epochs, "n_train": args.n_train,
        "n_test": args.n_test, "serving_mode": args.serving_mode,
        "train_frames": int(ds.imu.shape[0]),
        "steps": int(state.step), "synth_s": synth_s, "train_s": train_s,
        "eval_s": eval_s, "untrained": means["untrained"],
        "trained": means["trained"], "launches": launches}
    print(json.dumps(res), flush=True)
    return res


def main(argv=None):
    res = run(parse_args(argv))
    untrained, trained = res["untrained"], res["trained"]
    if not trained["angle_deg"] < untrained["angle_deg"] * 0.8:
        raise AssertionError("training did not improve pose error")
    print("OK: end-to-end pipeline learns "
          f"({untrained['angle_deg']:.1f} -> "
          f"{trained['angle_deg']:.1f} deg)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
