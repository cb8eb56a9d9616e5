"""CLI: pack per-motion pickles into training blobs (twin of
tip_tpu/cli/combine_data.py).

  python -m tip_tpu_torch.cli.combine_data --data_root data --tag v1 \
      [--datasets syn_AMASS_CMU syn_KIT ...] [--rates 100 250 ...]

The 60 in-tree motions:

  python -m tip_tpu_torch.cli.combine_data \
      --data_root artifacts/corpus_run_v3 --datasets corpus_extra \
      --rates 4 --out_prefix output/train_freeform2
"""

import argparse

# the reference dataset list + per-dataset downsample rates
DEFAULT_DATASETS = [
    ("syn_AMASS_CMU_v0", 100), ("syn_Eyes_Japan_Dataset_v0", 100),
    ("syn_KIT_v0", 250), ("syn_HUMAN4D_v0", 100), ("syn_ACCAD_v0", 60),
    ("syn_DFaust_67_v0", 60), ("syn_HumanEva_v0", 60),
    ("syn_MPI_Limits_v0", 60), ("syn_MPI_mosh_v0", 60), ("syn_SFU_v0", 60),
    ("syn_Transitions_mocap_v0", 60), ("syn_TotalCapture_v0", 60),
    ("preprocessed_DIP_IMU_v0_with_aug_c_train", 60),
]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data_root", default="data")
    ap.add_argument("--tag", default="v1")
    ap.add_argument("--datasets", nargs="*", default=None)
    ap.add_argument("--rates", nargs="*", type=int, default=None)
    ap.add_argument("--name_contains", nargs="*", default=None)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out_prefix", default=None,
                    help="blob prefix (default: <data_root>/train_<tag>)")
    args = ap.parse_args(argv)

    import os
    from tip_tpu_torch.data_gen.combine import combine

    if args.datasets:
        rates = args.rates or [60] * len(args.datasets)
        if len(rates) != len(args.datasets):
            ap.error(f"--rates needs one value per --datasets entry "
                     f"({len(args.datasets)} datasets, {len(rates)} rates)")
        pairs = list(zip(args.datasets, rates))
    else:
        pairs = [(d.replace("v0", args.tag), r) for d, r in DEFAULT_DATASETS]
    pairs = [(os.path.join(args.data_root, d), r) for d, r in pairs]
    pairs = [(d, r) for d, r in pairs if os.path.isdir(d)]
    out = args.out_prefix or os.path.join(args.data_root,
                                          f"train_{args.tag}")
    return combine([d for d, _ in pairs], [r for _, r in pairs],
                   out_prefix=out, name_contains=args.name_contains,
                   seed=args.seed)


if __name__ == "__main__":
    main()
