"""Convergence run on the card: corpus -> pack -> paper-recipe training ->
8-metric eval (twin of scripts/train_convergence.py, through tip_tpu_torch
only).

Trains the paper configuration (bs 256, lr 1e-4, AdamW wd 1e-4, per-batch
cosine with T_max = epochs + 850, clip 5.0, history noise U(+-0.15),
past_dropout 0.8, 5 SBPs, acc-sum feature, seed 5104) in the recipe's
model configuration (bf16 compute, the RNN kernels K1/K10 in bf16, the
per-op encoder layer loop, rng dropout) on the procedural corpus
(tip_tpu_torch/data_gen/corpus.py), one epoch at a time
(train.make_epoch_fn), then runs the offline metric protocol on held-out
motions in the serving modes tip_tpu's script evaluates. Results land in
<out>/results.json.

Every phase is resumable: corpus files are skipped when present, packing
is skipped when the blobs exist, training restores the newest checkpoint
under <out>/ckpt, its own ckpt_*.pt or a tip_tpu run's orbax step
(parameters, moments, step and generators) and, with the host sampler,
replays the numpy stream of the epochs already done; the eval caches each
mode's metrics for the checkpoint's step.

Run (on the card; --device cpu runs it on the CPU):
  python scripts/torch_train_convergence.py --epochs 1100 \\
      --out output/corpus_run --sampler device
The widths, the batch size and the batches an epoch can be cut for a
quick run (--tf_in_dim, --tf_nhid, --n_heads, --tf_layers, --rnn_nhid,
--batch_size, --max_batches).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

TEST_DURATION_S = 12.5          # fixed-length held-out clips, >= 12.5 s so
                                # that root_drift_10s measures a true 10 s
                                # after the 30/6 crops and the latency trim
SAVE_EVERY = 25                 # epochs between checkpoints, as tip_tpu's
EVAL_MODES = (("recompute", False), ("kv_cache", False),
              ("kv_cache_rnn_carry", False), ("recompute_full_terrain", True))
# what this script leaves out on purpose, by flag -> why (ROADMAP A7)
UNPORTED = {
    "git_ckpt_every": "committing checkpoints into the repo (a TPU host's "
                      "durability step, not carried over; ROADMAP A7)",
    "platform": "choosing a JAX backend (none here; ROADMAP A7: the port "
                "takes --device)",
}
# the recipe's widths (ModelConfig's defaults) and batch size
RECIPE = dict(tf_in_dim=256, tf_hid_size=1024, n_heads=16, tf_layers=4,
              rnn_hid_size=512, batch_size=256)


def phase_corpus(out, n_train, n_test, exclude=(), skip_train=False,
                 skip_test=False, device=None, log=print):
    from tip_tpu_torch.data_gen import corpus
    t0 = time.time()
    n = 0
    if not skip_train:
        n += corpus.generate_corpus(os.path.join(out, "corpus_train"),
                                    n_train, seed=100, exclude=exclude,
                                    log=log, device=device)
    if not skip_test:
        n += corpus.generate_corpus(os.path.join(out, "corpus_test"), n_test,
                                    seed=900, duration_s=TEST_DURATION_S,
                                    exclude=exclude, log=log, device=device)
    log(f"corpus: {n} new motions ({time.time() - t0:.0f}s)")
    return n


def phase_supplement(out, family, n, seed, device=None, log=print):
    """A single-family training supplement (<out>/corpus_extra), packed
    beside the base corpus."""
    from tip_tpu_torch.data_gen import corpus
    t0 = time.time()
    n_new = corpus.generate_corpus(os.path.join(out, "corpus_extra"), n,
                                   seed=seed, families=(family,), log=log,
                                   device=device)
    log(f"supplement: {n_new} new {family} motions "
        f"({time.time() - t0:.0f}s)")
    return n_new


def phase_pack(out, train_dirs=None, log=print):
    from tip_tpu_torch.data_gen.combine import combine
    prefix = os.path.join(out, "packed")
    if os.path.exists(prefix + "_imu.npy"):
        return prefix
    t0 = time.time()
    dirs = list(train_dirs or [os.path.join(out, "corpus_train")])
    combine(dirs, [1] * len(dirs), prefix, seed=0)
    log(f"packed in {time.time() - t0:.0f}s")
    return prefix


def make_train_cfg(epochs, dropout_impl="rng", **sizes):
    """The recipe's TrainConfig; ``sizes`` overrides RECIPE's widths and
    batch size."""
    from tip_tpu_torch import constants as cst
    from tip_tpu_torch.models.tip_model import ModelConfig
    from tip_tpu_torch.train import train as train_lib
    sizes = dict(RECIPE, **sizes)
    batch_size = sizes.pop("batch_size")
    model_cfg = ModelConfig(size_s=cst.state_dim(5), with_acc_sum=True,
                            compute_dtype="bfloat16", rnn_impl="auto",
                            encoder_impl="xla", dropout_impl=dropout_impl,
                            **sizes)
    return train_lib.TrainConfig(
        model=model_cfg, n_sbps=5, epochs=epochs, optimizer="AdamW",
        batch_size=batch_size, dropout_rng_impl="rbg")


def epoch_batches(info, cfg, max_batches=None):
    """(windows an epoch, its full batches, at most ``max_batches``)."""
    from tip_tpu_torch.train import data as data_lib
    n_windows = len(data_lib.sample_epoch_indices(
        info, cfg.seq_len, np.random.default_rng(0)))
    n_batches = n_windows // cfg.batch_size
    if max_batches is not None:
        n_batches = min(n_batches, max_batches)
    return n_windows, n_batches


def phase_train(out, prefix, epochs, dropout_impl="rng", sampler="host",
                device=None, max_batches=None, save_every=SAVE_EVERY,
                on_epoch=None, log=print, **sizes):
    """Whole-epoch training (``train.make_epoch_fn``), resumed from the
    newest checkpoint under <out>/ckpt. sampler "device" draws each
    epoch's window ends on the device from the state's generator
    (``data.WindowSampler``): its schedule is a pure function of the
    checkpointed state. "host" keeps the numpy stream (seeded from the
    config) and replays the epochs already done on resume. A checkpoint
    every ``save_every`` epochs and after the last. ``on_epoch(ep, state,
    aux)``: called after each epoch. Returns the checkpoint directory."""
    import torch

    from tip_tpu_torch.train import data as data_lib
    from tip_tpu_torch.train import train as train_lib
    from tip_tpu_torch.utils.observability import MetricsWriter

    cfg = make_train_cfg(epochs, dropout_impl, **sizes)
    ds = data_lib.PackedDataset.from_prefix(prefix, with_acc_sum=True)
    ckpt_dir = os.path.join(out, "ckpt")
    np_rng = np.random.default_rng(cfg.seed)
    n_windows, n_batches = epoch_batches(ds.info, cfg, max_batches)
    if n_batches < 1:
        raise ValueError(f"{n_windows} windows an epoch: not one batch of "
                         f"{cfg.batch_size}")
    log(f"dataset: {ds.imu.shape[0]} frames, {n_windows} windows/epoch, "
        f"{n_batches} batches/epoch")

    done_epochs = 0
    try:
        state = train_lib.restore_checkpoint(ckpt_dir, cfg, device=device)
        done_epochs = int(state.step) // n_batches
    except FileNotFoundError:
        state = train_lib.init_state(cfg, device)
    if done_epochs and sampler == "host":
        # replay the numpy stream so that resumed epochs draw the windows
        # they would have drawn uninterrupted
        for _ in range(done_epochs):
            data_lib.sample_epoch_indices(ds.info, cfg.seq_len, np_rng)
    if done_epochs:
        log(f"resumed at step {int(state.step)} (epoch {done_epochs})")
    if done_epochs >= epochs:
        log("training already complete")
        return ckpt_dir

    dev = state.step.device
    device_data = data_lib.to_device(ds, dev)
    if sampler == "device":
        wsampler = data_lib.make_window_sampler(ds.info, cfg.seq_len, dev)
        epoch_fn = train_lib.make_epoch_fn(cfg, device_data,
                                           sampler=wsampler,
                                           n_batches=n_batches)
    else:
        epoch_fn = train_lib.make_epoch_fn(cfg, device_data)
    writer = MetricsWriter(os.path.join(out, "train_metrics.jsonl"))
    t_start = time.time()
    try:
        for ep in range(done_epochs + 1, epochs + 1):
            if sampler == "device":
                t0 = time.time()
                state, aux = epoch_fn(state)
            else:
                idx = data_lib.sample_epoch_indices(ds.info, cfg.seq_len,
                                                    np_rng)
                ends = torch.as_tensor(
                    idx[:n_batches * cfg.batch_size].reshape(
                        n_batches, cfg.batch_size), device=dev)
                t0 = time.time()
                state, aux = epoch_fn(state, ends)
            aux = {k: v.cpu().numpy() for k, v in aux.items()}
            rec = {"epoch": ep, "mean_loss": float(np.nanmean(aux["loss"])),
                   "last_loss": float(aux["loss"][-1]),
                   "lr": float(aux["lr"][-1]),
                   "grad_norm": float(aux["grad_norm"].mean()),
                   "skipped": int(aux["skipped"].sum()),
                   "epoch_s": round(time.time() - t0, 2)}
            writer.write(**rec)
            if ep % 10 == 0 or ep == done_epochs + 1:
                per_ep = (time.time() - t_start) / (ep - done_epochs)
                log(json.dumps(rec) + f"  eta "
                    f"{per_ep * (epochs - ep) / 3600:.2f}h")
            if ep % save_every == 0 or ep == epochs:
                train_lib.save_checkpoint(ckpt_dir, state, ep * n_batches)
            if on_epoch is not None:
                on_epoch(ep, state, aux)
    finally:
        writer.close()
    return ckpt_dir


def eval_model_cfg(**sizes):
    """The eval's model: tip_tpu's script evaluates in float32 with its
    default per-op encoder loop, no training dropout."""
    from tip_tpu_torch import constants as cst
    from tip_tpu_torch.models.tip_model import ModelConfig
    sizes = {k: v for k, v in dict(RECIPE, **sizes).items()
             if k != "batch_size"}
    return ModelConfig(size_s=cst.state_dim(5), with_acc_sum=True,
                       encoder_impl="xla", **sizes)


class _FamilyCollector:
    """Receives the harness's per-motion records and groups metric means
    by corpus family (the file name's prefix)."""

    def __init__(self):
        self.rows = {}

    def write(self, kind=None, file=None, **metrics):
        if kind == "motion" and file:
            fam = os.path.basename(file).rsplit("_", 1)[0]
            self.rows.setdefault(fam, []).append(metrics)

    def by_family(self):
        out = {}
        for fam, rows in sorted(self.rows.items()):
            keys = [k for k, v in rows[0].items()
                    if isinstance(v, (int, float))]
            out[fam] = {"n": len(rows),
                        **{k: round(float(np.mean([r[k] for r in rows])), 4)
                           for k in keys}}
        return out


def phase_eval(out, epochs, test_dir=None, test_len=690,
               results_name="results.json", family_filter=None,
               with_sbp_metrics=True, with_terrain_metrics=True,
               device=None, log=print, **sizes):
    """The offline metric protocol on <out>/corpus_test (or ``test_dir``)
    in each of EVAL_MODES, for the newest checkpoint;
    each mode's metrics are cached in <out>/<results_name> for that
    checkpoint's step. The decode and tail run by the runner's default
    route (K2/K3 on the card). Returns the results."""
    from tip_tpu_torch import eval_harness as H
    from tip_tpu_torch import resolve_device
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.runtime import runner as runner_lib
    from tip_tpu_torch.train import train as train_lib

    device = resolve_device(device)
    state = train_lib.restore_checkpoint(
        os.path.join(out, "ckpt"), make_train_cfg(epochs, **sizes),
        params_only=True, device=device)
    step = int(state.step)
    log(f"eval at step {step}")
    eval_model = eval_model_cfg(**sizes)
    model = M.TIPModel(eval_model, device=device)
    model.load_state_dict(state.model.state_dict())
    model.requires_grad_(False)
    del state
    test_dir = test_dir or os.path.join(out, "corpus_test")
    files = [os.path.join(test_dir, f) for f in sorted(os.listdir(test_dir))
             if f.endswith(".pkl")]
    if family_filter:
        files = [f for f in files
                 if os.path.basename(f).rsplit("_", 1)[0] in family_filter]

    results = {"step": step, "n_test": len(files), "modes": {}}
    res_path = os.path.join(out, results_name)
    if os.path.exists(res_path):
        with open(res_path) as f:
            cached = json.load(f)
        # a cached mode counts only for this checkpoint's step
        if cached.get("step") == step:
            results = cached

    for name, full in EVAL_MODES:
        if name in results["modes"]:
            continue
        ecfg = H.EvalConfig(
            runner=runner_lib.RunnerConfig(
                model=eval_model, n_sbps=5, with_acc_sum=True,
                serving_mode="recompute" if full else name),
            use_full_runner=full, multi_sbp=full, test_len=test_len,
            max_motions_per_cat=len(files),
            # corpus walks wander well past the reference's +-5 m grid
            terrain_map_bound=16.0)
        t0 = time.time()
        extras = {}
        fc = _FamilyCollector()
        per_motion, means, maxima = H.evaluate(
            model, ecfg, files, log=lambda *a: None, metrics_writer=fc,
            extras_out=extras if (with_sbp_metrics or (
                full and with_terrain_metrics)) else None, device=device)
        mode = {"means": means,
                "maxima": {k: {"value": v, "file": os.path.basename(f)}
                           for k, (v, f) in maxima.items()},
                "by_family": fc.by_family(), "n_motions": len(per_motion),
                "eval_s": round(time.time() - t0, 1)}
        if with_sbp_metrics and "sbp" in extras:
            mode["sbp"] = extras["sbp"]
        if full and with_terrain_metrics and "terrain" in extras:
            mode["terrain"] = extras["terrain"]
            if "terrain_by_family" in extras:
                mode["terrain_by_family"] = extras["terrain_by_family"]
        results["modes"][name] = mode
        log(f"{name} {json.dumps(means)}")
        with open(res_path, "w") as f:
            json.dump(results, f, indent=1)
    log(f"results -> {res_path}")
    return results


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--out", default="output/corpus_run")
    ap.add_argument("--epochs", type=int, default=1100)
    ap.add_argument("--n_train", type=int, default=260)
    ap.add_argument("--n_test", type=int, default=40)
    ap.add_argument("--phase", default="all",
                    choices=["all", "corpus", "pack", "train", "eval"])
    ap.add_argument("--dropout_impl", default="rng", choices=["rng", "hash"])
    ap.add_argument("--sampler", default="host", choices=["host", "device"],
                    help="device: each epoch's window ends drawn on the "
                         "device from the state's generator; host: the "
                         "numpy stream, replayed on resume")
    ap.add_argument("--data_prefix", default=None,
                    help="an existing packed-blob prefix (skips the corpus "
                         "and pack phases)")
    ap.add_argument("--test_dir", default=None,
                    help="held-out pickle dir (default <out>/corpus_test)")
    ap.add_argument("--test_len", type=int, default=690)
    ap.add_argument("--results", default="results.json")
    ap.add_argument("--exclude", action="append", default=[],
                    help="corpus family to exclude (repeatable)")
    ap.add_argument("--base_train_dir", default=None,
                    help="an existing training pickle dir to pack instead "
                         "of generating <out>/corpus_train")
    ap.add_argument("--supplement", default=None, metavar="FAMILY:N:SEED",
                    help="also generate <out>/corpus_extra with N motions "
                         "of one family and pack it beside the base corpus")
    ap.add_argument("--eval_family", action="append", default=[],
                    help="restrict eval to these families (repeatable)")
    ap.add_argument("--save_every", type=int, default=SAVE_EVERY,
                    help="epochs between checkpoints")
    ap.add_argument("--max_batches", type=int, default=None,
                    help="at most this many batches an epoch")
    ap.add_argument("--batch_size", type=int, default=RECIPE["batch_size"])
    ap.add_argument("--tf_in_dim", type=int, default=RECIPE["tf_in_dim"])
    ap.add_argument("--tf_nhid", type=int, default=RECIPE["tf_hid_size"])
    ap.add_argument("--n_heads", type=int, default=RECIPE["n_heads"])
    ap.add_argument("--tf_layers", type=int, default=RECIPE["tf_layers"])
    ap.add_argument("--rnn_nhid", type=int, default=RECIPE["rnn_hid_size"])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions)")
    ap.add_argument("--git_ckpt_every", type=int, default=0,
                    help="not ported: " + UNPORTED["git_ckpt_every"])
    ap.add_argument("--platform", default=None,
                    help="not ported: " + UNPORTED["platform"])
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    for flag, on in (("git_ckpt_every", args.git_ckpt_every),
                     ("platform", args.platform)):
        if on:
            raise NotImplementedError(f"--{flag}: {UNPORTED[flag]} is not "
                                      f"ported")
    from tip_tpu_torch import resolve_device
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    sizes = dict(tf_in_dim=args.tf_in_dim, tf_hid_size=args.tf_nhid,
                 n_heads=args.n_heads, tf_layers=args.tf_layers,
                 rnn_hid_size=args.rnn_nhid, batch_size=args.batch_size)
    sup = None
    if args.supplement:
        fam, n_sup, seed_sup = args.supplement.split(":")
        sup = (fam, int(n_sup), int(seed_sup))

    if args.phase in ("all", "corpus") and args.data_prefix is None:
        phase_corpus(args.out, args.n_train, args.n_test,
                     exclude=tuple(args.exclude),
                     skip_train=args.base_train_dir is not None,
                     skip_test=args.test_dir is not None, device=device)
        if sup:
            phase_supplement(args.out, *sup, device=device)
    prefix = args.data_prefix or os.path.join(args.out, "packed")
    if args.phase in ("all", "pack") and args.data_prefix is None:
        train_dirs = [args.base_train_dir
                      or os.path.join(args.out, "corpus_train")]
        if sup:
            train_dirs.append(os.path.join(args.out, "corpus_extra"))
        prefix = phase_pack(args.out, train_dirs)
    results = None
    if args.phase in ("all", "train"):
        phase_train(args.out, prefix, args.epochs,
                    dropout_impl=args.dropout_impl, sampler=args.sampler,
                    device=device, max_batches=args.max_batches,
                    save_every=args.save_every, **sizes)
    if args.phase in ("all", "eval"):
        results = phase_eval(args.out, args.epochs, test_dir=args.test_dir,
                             test_len=args.test_len,
                             results_name=args.results,
                             family_filter=set(args.eval_family) or None,
                             device=device, **sizes)
    return results


if __name__ == "__main__":
    main()
