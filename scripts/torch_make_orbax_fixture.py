"""Write the small orbax checkpoint that the port's orbax reader is held
against: tests/data/orbax_tiny/ and its digests tests/data/orbax_tiny.json.

The checkpoint is tip_tpu's own (this script imports tip_tpu and JAX, as
the tests do; the port never does): the model at the small widths of
chip_smoke.py's path S (tf_in_dim 32, tf_hid_size 64, 4 heads, 2 layers,
rnn_hid_size 24), five SBPs with the acc-sum feature, AdamW with the
global-norm clip, after two train steps of tip_tpu's make_train_step on
batches of 8 windows of 40 frames cut from the in-tree motion
artifacts/corpus_run_v3/corpus_extra/freeform2_0000.pkl, so that the
moments, Adam's count and the step are not zeros; saved by tip_tpu's
save_checkpoint at step 2. The JSON lists each array as tip_tpu's
restore_checkpoint returns it: orbax's parameter name, shape, dtype and the
SHA-256 of its bytes (``tobytes``, C order).

Run (on the CPU, about 15 s):
  python scripts/torch_make_orbax_fixture.py [--out tests/data]
"""

import argparse
import hashlib
import json
import os
import pickle
import shutil
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MOTION = os.path.join(ROOT, "artifacts", "corpus_run_v3", "corpus_extra",
                      "freeform2_0000.pkl")
WIDTHS = dict(tf_in_dim=32, tf_hid_size=64, n_heads=4, tf_layers=2,
              rnn_hid_size=24)
B, T, STEPS = 8, 40, 2


def train_config():
    from tip_tpu.models import tip_model as JM
    from tip_tpu.train import train as JT
    return JT.TrainConfig(model=JM.ModelConfig(**WIDTHS, size_s=131,
                                               with_acc_sum=True),
                          n_sbps=5, batch_size=B, seq_len=T, lr=1e-3,
                          optimizer="AdamW", clip=5.0, epochs=20, seed=11)


def leaf_name(path) -> str:
    """orbax's parameter name of a pytree path: its keys joined by dots."""
    parts = []
    for k in path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
        else:
            raise TypeError(f"unknown pytree key {k!r}")
    return ".".join(parts)


def digests(state) -> dict:
    """{name: {shape, dtype, sha256}} of every array leaf of a TrainState."""
    import jax
    import numpy as np
    tree = {"params": state.params, "opt_state": state.opt_state,
            "step": state.step, "rng": state.rng}
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.asarray(leaf)
        out[leaf_name(path)] = {"shape": list(a.shape), "dtype": a.dtype.str,
                                "sha256": hashlib.sha256(a.tobytes())
                                .hexdigest()}
    return dict(sorted(out.items()))


def make(out_dir: str):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tip_tpu.data_gen import combine as JC
    from tip_tpu.train import data as JD
    from tip_tpu.train import train as JT

    cfg = train_config()
    with open(MOTION, "rb") as f:       # in-tree motion written by data gen
        payload = pickle.load(f)
    imu, acc_sum, s = JC.process_motion(payload, False,
                                        np.random.default_rng(0))
    ds = JD.PackedDataset(imu=imu, acc_sum=acc_sum, s=s,
                          info=np.array([[0, len(imu), 1]]))
    state = JT.init_state(cfg)
    step = JT.make_train_step(cfg)
    for i in range(STEPS):
        ends = T + 3 + np.arange(B) * 37 + i * 11
        batch = JD.gather_batch(ds, ends, T)
        state, _ = step(state, *(jnp.asarray(a) for a in batch))
    jax.block_until_ready(state.params)

    ckpt = os.path.join(out_dir, "orbax_tiny")
    shutil.rmtree(ckpt, ignore_errors=True)
    JT.save_checkpoint(ckpt, state, STEPS)
    restored = JT.restore_checkpoint(ckpt, cfg)
    table = digests(restored)
    with open(os.path.join(out_dir, "orbax_tiny.json"), "w") as f:
        json.dump({"step": STEPS, "widths": WIDTHS, "n_sbps": 5,
                   "with_acc_sum": True, "optimizer": "AdamW", "clip": 5.0,
                   "arrays": table}, f, indent=1)
        f.write("\n")
    size = sum(os.path.getsize(os.path.join(d, n))
               for d, _, names in os.walk(ckpt) for n in names)
    print(f"wrote {ckpt} ({size} bytes, {len(table)} arrays) and "
          f"orbax_tiny.json")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=os.path.join(ROOT, "tests", "data"))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    make(args.out)


if __name__ == "__main__":
    main()
