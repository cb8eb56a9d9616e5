"""CLI: import a reference torch checkpoint as a checkpoint of this
package (twin of tip_tpu/cli/import_torch_ckpt.py).

Translates a ``TF_RNN_Past_State.state_dict()`` .pt file (the reference's
shipped model-with/without-dip9and10.pt format) into the port's parameters
(``params_from_torch_state_dict``) and saves them as a training state
(``init_state``, ``save_checkpoint``: ``<out>/ckpt_0.pt``), which the
evaluator (cli/evaluate.py) and ``cli/train --warm_start`` read.

  python -m tip_tpu_torch.cli.import_torch_ckpt \
      --pt output/model-without-dip9and10.pt --out output/model-imported \
      --five_sbp --with_acc_sum
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--five_sbp", action="store_true")
    ap.add_argument("--with_acc_sum", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of the state made on the way "
                         "(default cuda; the checkpoint is the same)")
    args = ap.parse_args(argv)

    import torch
    from tip_tpu_torch import constants as cst
    from tip_tpu_torch import resolve_device
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.train import train as train_lib

    device = resolve_device(args.device)
    n_sbps = 5 if args.five_sbp else 2
    cfg = M.ModelConfig(size_s=cst.state_dim(n_sbps),
                        with_acc_sum=args.with_acc_sum)
    sd = torch.load(args.pt, map_location="cpu", weights_only=True)
    params = M.params_from_torch_state_dict(sd, cfg)
    print(f"imported {sum(v.numel() for v in params.values()):,} parameters")

    tcfg = train_lib.TrainConfig(model=cfg, n_sbps=n_sbps)
    state = train_lib.init_state(tcfg, device=device)
    with torch.no_grad():
        for k, p in state.model.named_parameters():
            p.copy_(params[k])
    train_lib.save_checkpoint(args.out, state, 0)
    print("saved checkpoint to", args.out)
    return state


if __name__ == "__main__":
    main()
