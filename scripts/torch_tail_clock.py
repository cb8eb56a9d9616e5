#!/usr/bin/env python3
"""The per-frame tail kernels K2 (decode_fused), K3 (tail_fused) and K6
(fk_bullet_fused) on one GPU: the launch floor, device and eager times at
B 1 and B 64, and their per-phase clocks.

    python3 scripts/torch_tail_clock.py

Prints:

  - the card's name and power limit, its SM clock, and a probe of the
    timers: the step of %globaltimer in a tight loop, and the SM's cycles
    per ns of %globaltimer (the clocks count cycles, clock64, and convert
    with it);
  - the launch floor: an empty kernel of B blocks of 32 threads that
    writes one float a block, timed as the kernels are;
  - for each kernel at B 1 and 64: its largest difference from its plain
    version on chip_smoke.py's random inputs, its device ms
    (chip_smoke.graph_ms: 20 calls in a CUDA graph, 50 replays), its eager
    ms (chip_smoke.time_ms: CUDA events around one call, median of 200),
    the host us of one call without a sync (chip_smoke.host_us, median of
    200), the device ms of a (producer op -> kernel) pair in a graph less
    the producer's alone, and its time by phase (chip_smoke.phase_clock:
    the median over 41 clocked launches of block 0's cycle stamps; the
    clocked launch's outputs must equal the unclocked one's);
  - chip_smoke.race_check: K2 and K3 each after the op that writes their
    input, 20 pairs in a graph, held against their plain versions;

then one JSON object. Exits non-zero without CUDA or when a kernel
disagrees with its plain version.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tip_tpu_torch.ops import _kernels as K  # noqa: E402

CLOCKED = 41
BATCHES = (1, cs.POOL_CAPACITY)


def pair_ms(kernel, produce):
    """Device ms of a (producer -> kernel) pair less the producer's alone:
    the producer writes a fresh tensor that the kernel reads."""
    pair = cs.graph_ms(lambda: kernel(produce()))
    alone = cs.graph_ms(produce)
    return pair - alone, pair, alone


def measure(dev, cycles_per_ns):
    from tip_tpu_torch.ops import fused_tail as FT
    from tip_tpu_torch.ops import kinematics as kin
    gen = torch.Generator(device=dev).manual_seed(1)
    skel = kin.amass_skeleton(device=dev)
    res = {}
    for B in BATCHES:
        out = torch.empty(B, device=dev)
        res[f"floor_B{B}"] = dict(
            ms=cs.graph_ms(lambda: FT.floor_launch(out)),
            call_ms=cs.time_ms(lambda: FT.floor_launch(out)),
            host_us=cs.host_us(lambda: FT.floor_launch(out)))
        x = cs.tail_inputs(B, dev, gen, skel)
        for name, (kernel, plain, phases, arg) in cs.tail_calls(
                x, skel).items():
            err = cs.max_err(cs.flat(kernel()), cs.flat(plain()))
            tol = cs.TOL_RES if name == "tail_fused" else cs.TOL
            if not err <= tol:
                raise AssertionError(f"{name} B {B}: max |kernel - plain| "
                                     f"{err:.3g} > {tol:g}")
            src = x[arg]
            extra, pair, alone = pair_ms(lambda a: kernel(**{arg: a}),
                                         lambda: src * 1.0)
            res[f"{name}_B{B}"] = dict(
                max_abs_err=err, ms=cs.graph_ms(kernel),
                call_ms=cs.time_ms(kernel), host_us=cs.host_us(kernel),
                after_producer_ms=extra, pair_ms=pair, producer_ms=alone,
                phases_ns=cs.phase_clock(kernel, phases, dev, cycles_per_ns,
                                         n=CLOCKED))
            print(f"  {name} B {B}: {json.dumps(res[f'{name}_B{B}'])}",
                  flush=True)
    res["race_check_max_abs_err"] = cs.race_check(dev, gen, skel)
    return res


def sm_clocks():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def main():
    if not torch.cuda.is_available():
        print("torch_tail_clock: no CUDA device", file=sys.stderr)
        return 1
    from tip_tpu_torch.ops import fused_tail as FT
    card = cs.card_info()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    K.build_all(("fused_tail", "fused_fk"))
    dev = torch.device("cuda")
    FT.timer_probe(dev)
    probe = FT.timer_probe(dev)
    print(f"timers: {json.dumps(probe)}; SM clock now, max: {sm_clocks()}",
          flush=True)
    res = measure(dev, probe["cycles_per_ns"])
    print(json.dumps({"tail_clock": res, "timers": probe,
                      "sm_clocks": sm_clocks(), "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
