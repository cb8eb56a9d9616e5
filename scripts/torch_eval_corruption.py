#!/usr/bin/env python3
"""Sensor-corruption degradation sweep over a converged checkpoint (twin of
scripts/eval_corruption.py, through tip_tpu_torch only).

The held-out corpus is re-evaluated under escalating off-distribution
sensor corruption (eval_corruption.SWEEP: NaN dropout bursts repaired by
the reference imputation path, constant acc bias beyond the train-time
+-0.1, calibration rotation error) and the metric table is written per
rung. The checkpoint is read by train.restore_checkpoint (parameters only;
a tip_tpu orbax run through the port's own reader, utils/orbax_read.py)
under the recipe's TrainConfig (scripts/torch_train_convergence.py's
make_train_cfg), and each rung evaluates it as tip_tpu's script does:
ModelConfig(size_s=state_dim(5), with_acc_sum=True), 5 SBPs, on the
default route (K1, K11, K2, K3 on the card).

Usage:
    python3 scripts/torch_eval_corruption.py --out <run dir holding ckpt/> \\
        [--test_dir DIR] [--results corruption.json] [--mode recompute] \\
        [--test_len 690] [--n_motions 20] [--epochs 1100] [--device cuda]
        [--compare_cpu]

The results file (<out>/<results>) has tip_tpu's layout: step, mode,
n_test and per rung its config, means, worst_angle and eval_s, beside
test_len, the device, the card and each rung's kernel launches; a rung
already in it is not run again where step, mode, n_test, test_len and
device all match this run's (else the file is started afresh). --out
defaults to output/, never to tip_tpu's run directories, whose tracked
results are the TPU's. --compare_cpu runs the
clean rung and the first rung of each corruption kind on the device and
on the CPU and writes each metric's largest difference over the motions
beside the tolerances (angles 1e-3 deg, drifts 1e-4 m) into
<results stem>_cpu_check.json; it exits 1 where one is exceeded.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "scripts")]

# --compare_cpu: the device run against the CPU run, per motion, by unit
CPU_CHECK_TOL = {"angle_deg": 1e-3, "sip_deg": 1e-3, "root_drift_2s": 1e-4,
                 "root_drift_5s": 1e-4, "root_drift_10s": 1e-4}


def eval_model_config():
    """The model configuration tip_tpu's script evaluates in."""
    from tip_tpu_torch import constants as cst
    from tip_tpu_torch.models.tip_model import ModelConfig
    return ModelConfig(size_s=cst.state_dim(5), with_acc_sum=True)


def rung_eval_config(cor, model_cfg, mode, test_len, n_files):
    """The EvalConfig of one rung, as tip_tpu's script builds it."""
    from tip_tpu_torch import eval_harness as H
    from tip_tpu_torch.runtime import runner as runner_lib
    return H.EvalConfig(
        runner=runner_lib.RunnerConfig(model=model_cfg, n_sbps=5,
                                       with_acc_sum=True, serving_mode=mode),
        test_len=test_len, max_motions_per_cat=n_files,
        corruption=None if cor.label() == "clean" else cor)


def run_rung(weights, model_cfg, cor, files, mode, test_len, device):
    """One rung: a model of ``model_cfg`` holding ``weights`` (a state
    dict, in the dtype of the run) on ``device``, through the harness.
    Returns (per-motion metrics, means, maxima, seconds, the kernels'
    launches)."""
    import torch

    from tip_tpu_torch import eval_harness as H
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.ops import _kernels as K
    dtype = next(iter(weights.values())).dtype
    model = M.TIPModel(model_cfg, device=device, dtype=dtype)
    model.load_state_dict(weights)
    ecfg = rung_eval_config(cor, model_cfg, mode, test_len, len(files))
    K.reset_launch_counts()
    t0 = time.time()
    with torch.no_grad():
        per_motion, means, maxima = H.evaluate(model, ecfg, files,
                                               log=lambda *a: None,
                                               device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    launches = {k: n for k, n in sorted(K.launch_counts.items()) if n}
    return per_motion, means, maxima, time.time() - t0, launches


def cached_results(path, key):
    """The results file at ``path`` where its step, mode, n_test, test_len
    and device equal ``key``'s, else a fresh results dict of ``key``."""
    if os.path.exists(path):
        with open(path) as f:
            cached = json.load(f)
        if all(cached.get(k) == v for k, v in key.items()):
            return cached
    return {**key, "rungs": {}}


def first_of_each_kind(sweep):
    """The clean rung and the first rung of each corruption kind (bias,
    calibration, dropout) alone."""
    first = {}
    for cor in sweep:
        on = tuple(f for f in ("acc_bias", "calib_rot_deg",
                               "dropout_rate_hz") if getattr(cor, f))
        if len(on) <= 1:
            first.setdefault(on, cor)
    return list(first.values())


def compare_cpu(weights, model_cfg, files, args, device):
    """--compare_cpu: each picked rung on ``device`` and on the CPU; the
    largest difference a metric over the motions, and whether each lies
    within CPU_CHECK_TOL."""
    from tip_tpu_torch import eval_corruption as EC
    cpu_weights = {k: v.cpu() for k, v in weights.items()}
    out = {}
    for cor in first_of_each_kind(EC.SWEEP):
        dev_m = run_rung(weights, model_cfg, cor, files, args.mode,
                         args.test_len, device)
        cpu_m = run_rung(cpu_weights, model_cfg, cor, files, args.mode,
                         args.test_len, "cpu")
        diff = {k: max(abs(a[k] - b[k]) for a, b in zip(dev_m[0], cpu_m[0]))
                for k in dev_m[0][0]}
        out[cor.label()] = {
            "n_motions": len(dev_m[0]), "max_abs_diff": diff,
            "device_means": dev_m[1], "cpu_means": cpu_m[1],
            "device_s": dev_m[3], "cpu_s": cpu_m[3],
            "device_launches": dev_m[4],
            "within": all(diff[k] <= t for k, t in CPU_CHECK_TOL.items())}
        print(cor.label(), json.dumps({"max_abs_diff": diff}), flush=True)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "output"),
                    help="run directory holding ckpt/; the results go here")
    ap.add_argument("--test_dir", default=None)
    ap.add_argument("--results", default="corruption.json")
    ap.add_argument("--mode", default="recompute",
                    help="serving mode for the sweep")
    ap.add_argument("--test_len", type=int, default=690)
    ap.add_argument("--n_motions", type=int, default=0,
                    help="cap motions per rung (0 = all)")
    ap.add_argument("--epochs", type=int, default=1100)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels), or cpu (the plain versions)")
    ap.add_argument("--compare_cpu", action="store_true",
                    help="hold the clean rung and the first rung of each "
                         "kind on the device against the CPU")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from tip_tpu_torch import eval_corruption as EC
    from tip_tpu_torch import resolve_device
    from tip_tpu_torch.train import train as train_lib

    from torch_train_convergence import make_train_cfg

    device = resolve_device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch_eval_corruption: no CUDA device; the "
                           "port's kernels run on a GPU (--device cpu runs "
                           "the plain versions)")
    card = None
    if device.type == "cuda":
        import chip_smoke as cs
        cs.exact_math()
        from tip_tpu_torch.ops import _kernels as K
        K.build_all()
        card = cs.card_info()
        print(card, flush=True)

    cfg_t = make_train_cfg(args.epochs)
    state = train_lib.restore_checkpoint(os.path.join(args.out, "ckpt"),
                                         cfg_t, params_only=True,
                                         device=device)
    step = int(state.step)
    weights = {k: v.detach() for k, v in state.model.state_dict().items()}
    print(f"eval at step {step}")
    test_dir = args.test_dir or os.path.join(args.out, "corpus_test")
    files = [os.path.join(test_dir, f) for f in sorted(os.listdir(test_dir))
             if f.endswith(".pkl")]
    if args.n_motions:
        files = files[:args.n_motions]

    model_cfg = eval_model_config()
    res_path = os.path.join(args.out, args.results)
    if args.compare_cpu:
        check = {"step": step, "mode": args.mode, "test_len": args.test_len,
                 "device": str(device), "card": card,
                 "tolerance": CPU_CHECK_TOL,
                 "rungs": compare_cpu(weights, model_cfg, files, args,
                                      device)}
        check_path = os.path.splitext(res_path)[0] + "_cpu_check.json"
        with open(check_path, "w") as f:
            json.dump(check, f, indent=1)
        ok = all(r["within"] for r in check["rungs"].values())
        print(f"wrote {check_path}; within the tolerances: {ok}")
        return 0 if ok else 1

    results = cached_results(res_path, {
        "step": step, "mode": args.mode, "n_test": len(files),
        "test_len": args.test_len, "device": str(device)})
    results["card"] = card

    for cor in EC.SWEEP:
        label = cor.label()
        if label in results["rungs"]:
            print(f"{label}: cached")
            continue
        _, means, maxima, eval_s, launches = run_rung(
            weights, model_cfg, cor, files, args.mode, args.test_len, device)
        results["rungs"][label] = {
            "config": {k: v for k, v in cor.__dict__.items()},
            "means": means,
            "worst_angle": maxima["angle_deg"][0],
            "eval_s": round(eval_s, 1),
            "launches": launches}
        print(label, json.dumps(means), flush=True)
        with open(res_path, "w") as f:
            json.dump(results, f, indent=1)

    print(f"wrote {res_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
