"""CLI: preprocess DIP-IMU / TotalCapture real sensor recordings (twin of
tip_tpu/cli/preprocess_dip.py; reference preprocess_DIP_TC_new.py:341-396).

  # DIP: per-subject pkls under <src>/s_XX/*.pkl; writes dipimu_s_XX_YY.pkl,
  # merges shipped SBP labels, and copies the s01-08 train split.
  python -m tip_tpu_torch.cli.preprocess_dip --dip \
      --src_dir data/source/DIP_IMU \
      --sbp_dir data/source/preprocessed_DIP_IMU_c \
      --save_dir data/preprocessed_DIP_IMU_v1

  # TotalCapture: AMASS-format gt + 60FPS real IMU pkls.
  python -m tip_tpu_torch.cli.preprocess_dip \
      --src_gt data/source/TotalCapture \
      --src_imu data/source/TotalCapture_60FPS_Original \
      --save_dir data/preprocessed_TotalCapture_v1

The ground truth is computed on ``cuda`` unless ``--device cpu`` is given.
"""

import argparse
import os
import pickle


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dip", action="store_true")
    ap.add_argument("--src_dir", default=None)
    ap.add_argument("--src_gt", default=None)
    ap.add_argument("--src_imu", default=None)
    ap.add_argument("--sbp_dir", default=None)
    ap.add_argument("--save_dir", required=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from tip_tpu_torch import resolve_device
    from tip_tpu_torch.data_gen import dip as dip_lib

    device = resolve_device(args.device)
    os.makedirs(args.save_dir, exist_ok=True)
    count = 0

    if args.dip:
        for d, _, files in os.walk(args.src_dir):
            for fn in sorted(files):
                if not fn.endswith(".pkl"):
                    continue
                save = os.path.join(
                    args.save_dir,
                    ("dipimu_" + d.rsplit("/", 1)[-1] + "_" + fn[:-4] + ".pkl"
                     ).replace(" ", "_"))
                if os.path.exists(save):
                    continue
                payload = dip_lib.preprocess_dip_file(os.path.join(d, fn),
                                                      device=device)
                with open(save, "wb") as f:
                    pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
                count += 1
                print("wrote", save)
        if args.sbp_dir:
            n = dip_lib.augment_with_sbp(args.save_dir, args.sbp_dir,
                                         args.save_dir + "_with_aug_c")
            print("sbp-augmented", n)
            n = dip_lib.copy_train_split(args.save_dir + "_with_aug_c")
            print("train split", n)
    else:
        for d, _, files in os.walk(args.src_gt):
            for fn in sorted(files):
                if not fn.endswith(".npz"):
                    continue
                local = d.rsplit("/", 1)[-1] + "_" + fn[:-10]
                imu_pkl = os.path.join(args.src_imu, local + ".pkl")
                save = os.path.join(args.save_dir,
                                    ("tcimu_" + local + ".pkl").replace(" ", "_"))
                if os.path.exists(save) or "s5/freestyle3" in d + "/" + fn:
                    continue
                payload = dip_lib.preprocess_tc_pair(os.path.join(d, fn),
                                                     imu_pkl, device=device)
                with open(save, "wb") as f:
                    pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
                count += 1
                print("wrote", save)
    print("count", count)
    return count


if __name__ == "__main__":
    main()
