"""CLI: train the TIP state predictor (twin of tip_tpu/cli/train.py).

Paper run, on the card (pack the blobs first, cli/combine_data.py):
  python -m tip_tpu_torch.cli.train --data_prefix data/train_v1 \
      --save_path output/model-v1 --batch_size 256 --lr 1e-4 --epochs 1100 \
      --seq_len 40 --cosine_lr --weight_decay 1e-4 --optim AdamW --n_sbps 5 \
      --with_acc_sum --noise_input_hist 0.15 --seed 5104

The port's defaults are tip_tpu's kernel configuration (``--dropout_impl
hash --rnn_impl pallas --encoder_impl pallas``: K1, K10, K11, K12 on the
card). tip_tpu's own defaults (``--dropout_impl rng --rnn_impl scan
--encoder_impl xla``) train too: the rng masks from a torch.Generator on
the device, the plain RNN, the per-op encoder layer loop. ``--dropout_rng
threefry|rbg`` names tip_tpu's JAX generator; the port has one generator
and draws the same masks for either. Training runs in float32, or with
``--bf16`` in bfloat16 compute (the kernels' bf16 variants on the card;
the parameters, Adam's moments and the checkpoints stay float32), on
``cuda`` unless ``--device cpu`` is given; the windows are always gathered
on the device, so ``--device_data`` is accepted and changes nothing.
``--warm_start`` takes a checkpoint directory of this package, tip_tpu's
orbax checkpoint (read without orbax: utils/orbax_read.py) or a reference
``.pt`` state dict.

Over a (data, model) mesh, one process a device, under torchrun:
  torchrun --nproc_per_node 8 -m tip_tpu_torch.cli.train ... \
      --n_model_shards 2
builds a mesh of (world / n_model_shards, n_model_shards), each rank on
``cuda:LOCAL_RANK`` over NCCL (with ``--device cpu``, on the CPU over
gloo; ``--init_method`` names another rendezvous than torchrun's
MASTER_ADDR and MASTER_PORT). Rank 0 logs and writes the checkpoints,
which hold the whole state. With one process there is no mesh and
``--n_model_shards`` is ignored, as tip_tpu ignores it on one device.
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data_prefix", required=True,
                    help="blob prefix: <prefix>_imu.npy etc.")
    ap.add_argument("--save_path", required=True)
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--epochs", type=int, default=1100)
    ap.add_argument("--seq_len", type=int, default=40)
    ap.add_argument("--clip", type=float, default=5.0)
    ap.add_argument("--optim", default="Adam", choices=["Adam", "AdamW"])
    ap.add_argument("--weight_decay", type=float, default=1e-4)
    ap.add_argument("--cosine_lr", action="store_true")
    ap.add_argument("--n_sbps", type=int, default=5)
    ap.add_argument("--with_acc_sum", action="store_true")
    ap.add_argument("--noise_input_hist", type=float, default=0.15)
    ap.add_argument("--past_dropout", type=float, default=0.8)
    ap.add_argument("--in_dropout", type=float, default=0.0)
    ap.add_argument("--rnn_nhid", type=int, default=512)
    ap.add_argument("--tf_nhid", type=int, default=1024)
    ap.add_argument("--tf_in_dim", type=int, default=256)
    ap.add_argument("--n_heads", type=int, default=16)
    ap.add_argument("--tf_layers", type=int, default=4)
    ap.add_argument("--seed", type=int, default=5104)
    ap.add_argument("--n_model_shards", type=int, default=1,
                    help="tensor-parallel mesh axis size (several "
                         "processes only)")
    ap.add_argument("--init_method", default=None,
                    help="the process group's rendezvous (default: "
                         "torchrun's MASTER_ADDR and MASTER_PORT)")
    ap.add_argument("--warm_start", default=None,
                    help="checkpoint dir of this package, tip_tpu's orbax "
                         "checkpoint dir or reference .pt: load weights "
                         "only")
    ap.add_argument("--device_data", action="store_true",
                    help="accepted for tip_tpu's command lines; the port "
                         "always gathers the windows on the device")
    ap.add_argument("--metrics", default=None,
                    help="structured jsonl training log (default: "
                         "<save_path>/metrics.jsonl)")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute; parameters, optimizer state "
                         "and checkpoints stay float32")
    ap.add_argument("--dropout_rng", default="threefry",
                    choices=["threefry", "rbg"],
                    help="tip_tpu's JAX generator for the rng masks; the "
                         "port draws them from one torch.Generator on the "
                         "device for either")
    ap.add_argument("--dropout_impl", default="hash", choices=["rng", "hash"],
                    help="hash: counter-based masks from int32 seeds "
                         "(tip_tpu's bit for bit); rng: Bernoulli masks "
                         "from the device generator")
    ap.add_argument("--rnn_impl", default="pallas", choices=["scan", "pallas"],
                    help="pallas: the RNN kernels K1/K10 on the card; scan: "
                         "the plain loop")
    ap.add_argument("--encoder_impl", default="pallas",
                    choices=["xla", "pallas"],
                    help="pallas: the encoder-layer kernels K11/K12 on the "
                         "card; xla: the per-op layer loop, no kernel")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions)")
    args = ap.parse_args(argv)

    import os
    import torch
    from tip_tpu_torch import constants as cst
    from tip_tpu_torch.models.tip_model import ModelConfig
    from tip_tpu_torch.parallel import mesh as mesh_lib
    from tip_tpu_torch.train import data as data_lib
    from tip_tpu_torch.train import train as train_lib

    model_cfg = ModelConfig(
        size_s=cst.state_dim(args.n_sbps), with_acc_sum=args.with_acc_sum,
        tf_in_dim=args.tf_in_dim, tf_hid_size=args.tf_nhid,
        n_heads=args.n_heads, tf_layers=args.tf_layers,
        rnn_hid_size=args.rnn_nhid, in_dropout=args.in_dropout,
        past_dropout=args.past_dropout,
        compute_dtype="bfloat16" if args.bf16 else None,
        rnn_impl="auto" if args.rnn_impl == "pallas" else "plain",
        encoder_impl="auto" if args.encoder_impl == "pallas" else "xla",
        dropout_impl=args.dropout_impl)
    cfg = train_lib.TrainConfig(
        model=model_cfg, n_sbps=args.n_sbps, batch_size=args.batch_size,
        seq_len=args.seq_len, lr=args.lr, optimizer=args.optim,
        weight_decay=args.weight_decay, clip=args.clip, epochs=args.epochs,
        cosine_lr=args.cosine_lr, noise_input_hist=args.noise_input_hist,
        seed=args.seed, dropout_rng_impl=args.dropout_rng)
    ds = data_lib.PackedDataset.from_prefix(args.data_prefix,
                                            with_acc_sum=args.with_acc_sum)
    metrics = args.metrics or os.path.join(args.save_path, "metrics.jsonl")
    device, mesh = args.device, None
    kind = torch.device(device or "cuda").type
    if kind == "cuda" and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        # each rank binds its card before it joins the NCCL group
        if device in (None, "cuda"):
            device = f"cuda:{mesh_lib.local_rank()}"
        torch.cuda.set_device(torch.device(device))
    joined = mesh_lib.init_distributed(args.init_method, device=kind)
    try:
        if joined:
            mesh = mesh_lib.make_mesh(n_model=args.n_model_shards,
                                      device_type=kind)
            if torch.distributed.get_rank() == 0:
                print("mesh:", dict(zip(mesh.mesh_dim_names,
                                        mesh.mesh.shape)))
        return train_lib.train_loop(cfg, ds, mesh=mesh,
                                    ckpt_dir=args.save_path,
                                    warm_start=args.warm_start,
                                    metrics_path=metrics, device=device)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
