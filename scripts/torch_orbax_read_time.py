"""Time the port's orbax reader on the trained checkpoint of this clone's
history (7879398:artifacts/corpus_run_v2_repro/ckpt/389400, 220 arrays,
40.6 MB of values), extracted with ``git archive`` into a temporary
directory, never into the tree: ``read_orbax`` of the step and the
parameters-only ``restore_checkpoint`` on the CPU, each the median of
``--repeats`` runs after one warm read (the files' pages are then in the
host's cache). Prints one JSON line.

  python scripts/torch_orbax_read_time.py [--repeats 5]
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

COMMIT = "7879398"
CKPT = "artifacts/corpus_run_v2_repro/ckpt"
STEP = 389400


def timed(fn, repeats):
    fn()
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return statistics.median(out), out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)

    import torch
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.train import train as T
    from tip_tpu_torch.utils import orbax_read as OR

    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        archive = subprocess.run(
            ["git", "-C", ROOT, "archive", COMMIT, f"{CKPT}/{STEP}"],
            capture_output=True, check=True)
        subprocess.run(["tar", "-x", "-C", tmp], input=archive.stdout,
                       check=True)
        ckpt = os.path.join(tmp, CKPT)
        step = OR.step_dir(ckpt)
        arrays = OR.read_orbax(step)
        nbytes = sum(a.nbytes for a in arrays.values())
        read_s, reads = timed(lambda: OR.read_orbax(step), args.repeats)
        cfg = T.TrainConfig(model=M.ModelConfig(with_acc_sum=True),
                            optimizer="AdamW")
        restore_s, restores = timed(lambda: T.restore_checkpoint(
            ckpt, cfg, params_only=True, device="cpu"), args.repeats)
    print(json.dumps({"arrays": len(arrays), "array_bytes": nbytes,
                      "read_orbax_s": read_s, "read_orbax_runs_s": reads,
                      "restore_params_only_s": restore_s,
                      "restore_runs_s": restores,
                      "host": "CPU (no card), warm page cache"}))


if __name__ == "__main__":
    main()
