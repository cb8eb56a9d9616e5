#!/usr/bin/env python3
"""K11 bf16 and K12 bf16 (the bf16 encoder layer, forward and backward)
launch by launch, on one GPU.

    python3 scripts/torch_encoder_bf16_clock.py

At B 1, 64 and 256 (T 40, the full-width model's layer 0 in bf16 with
chip_smoke.py's ff1 shift, p 0): each product's launch plan
(ops/encoder_train.py's encoder_bf16_plan); the device ms of a call
(chip_smoke.graph_ms), its eager ms (chip_smoke.time_ms) and the host us
of a call without a sync (chip_smoke.host_us), beside
TransformerEncoderLayer bf16's forward and its autograd forward +
backward; and each launch of one call in order with its device us (the
median of three profiled calls, torch.profiler). Prints the card's name
and power limit first and one JSON object last.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402


def launches(fn, calls=3):
    """[(kernel name, device us)] of one call of fn, in launch order: the
    median over `calls` profiled calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    n = len(evs) // calls
    out = []
    for i in range(n):
        us = sorted(evs[i + k * n].device_time for k in range(calls))
        name = evs[i].name.replace("(anonymous namespace)::", "")
        out.append((name.split("(")[0][:48], us[calls // 2]))
    return out


def main():
    if not torch.cuda.is_available():
        print("torch_encoder_bf16_clock: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.ops import encoder_train as ET
    card = CS.card_info()
    print(card, flush=True)
    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1)
    model = M.TIPModel(M.ModelConfig(), device=dev,
                       generator=torch.Generator().manual_seed(0))
    ws = list(ET.pack_layer_weights(
        {k: v.detach().to(bf) for k, v in model.named_parameters()},
        "layers.0.", bf))
    ws[5] = ws[5] + CS.K12_FF1_SHIFT
    ws = tuple(w.contiguous() for w in ws)
    nh, d, ff, T = model.cfg.n_heads, ws[2].shape[0], ws[4].shape[1], 40
    layer = CS.library_encoder_layer(ws, nh, dev)
    mask = torch.nn.Transformer.generate_square_subsequent_mask(
        T, device=dev, dtype=bf)
    result = {"card": card}
    for B in (1, 64, 256):
        x = torch.randn(B, T, d, generator=gen, device=dev).to(bf)
        dy = torch.randn(B, T, d, generator=gen, device=dev).to(bf)
        xr = x.clone().requires_grad_(True)
        params = [xr] + list(layer.parameters())

        def lib_fwd():
            with torch.no_grad():
                return layer(x, src_mask=mask, is_causal=True)

        def lib_fwd_bwd():
            torch.autograd.grad(layer(xr, src_mask=mask, is_causal=True),
                                params, dy)

        calls = {
            "K11_bf16": lambda: ET.encoder_layer_fwd(
                x, ws, 0, nh, 0.0, False, 8, impl="kernel"),
            "K12_bf16": lambda: ET.encoder_layer_bwd(
                x, ws, 0, dy, nh, 0.0, False, 8, impl="kernel"),
            "library_fwd": lib_fwd, "library_fwd_bwd": lib_fwd_bwd}
        r = {"plan": CS.encoder_bf16_plans(B, T, d, ff)}
        for name, fn in calls.items():
            r[name] = dict(ms=CS.graph_ms(fn),
                           call_ms=CS.time_ms(fn, n=50, warmup=5),
                           host_us=CS.host_us(fn, n=50, warmup=5))
            if name.startswith("K1"):
                r[name]["launches"] = launches(fn)
            print(f"B {B} {name}: {json.dumps(r[name])}", flush=True)
        result[f"B{B}"] = r
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
