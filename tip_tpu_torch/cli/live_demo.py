"""CLI: live streaming demo (twin of tip_tpu/cli/live_demo.py; reference
live_demo_new.py:186-327).

Consumes 60 Hz IMU frames from the TCP bridge (native/imu_bridge or a real
sensor SDK speaking the same protocol), runs the two-stage calibration, and
streams poses through the full runner to a jsonl pose writer.

  # terminal 1: replay a recording through the bridge
  native/build/imu_bridge --replay recording.f32 --hz 60
  # terminal 2:
  python -m tip_tpu_torch.cli.live_demo --ckpt output/model-v1 \
      --with_acc_sum --five_sbp [--skip_calibration] [--seconds 30] \
      [--out poses.jsonl] [--record frames.f32] [--metrics m.jsonl] \
      [--device cpu]

``--ckpt`` takes what cli/evaluate.py's ``load_model`` takes: a checkpoint
directory of this package, tip_tpu's orbax checkpoint or a reference
``.pt`` state dict. The runner is on ``cuda`` unless ``--device cpu`` is
given. ``--viz`` shows the live pose, its SBP markers and the terrain in
the PyBullet viewer (needs the pybullet wheel).
"""

import argparse
import json
import time

import numpy as np


def mean_readings(client, seconds: float = 3.0, dt: float = 1.0 / 60.0):
    """The mean of the client's latest readings sampled every ``dt`` for
    ``seconds``."""
    buf = []
    t_end = time.time() + seconds
    while time.time() < t_end:
        buf.append(client.current_reading())
        time.sleep(dt)
    return np.mean(buf, axis=0)


def calibrate_client(client, seconds: float = 3.0, prompt=None):
    """The reference's two-stage calibration on a live client: sensors
    aligned with the room, then a T pose, each held ``seconds``; ``prompt``
    (default ``input``) waits for the user between the stages."""
    from tip_tpu_torch.runtime import calibration as cal_lib
    prompt = prompt or input
    prompt("Align all IMUs with the room axes, then press enter.")
    print(f"hold {seconds:g} s…")
    mean_aligned = mean_readings(client, seconds)
    prompt("Now wear the IMUs, stand in T-pose, press enter.")
    print(f"hold {seconds:g} s…")
    mean_tpose = mean_readings(client, seconds)
    return cal_lib.calibrate(mean_aligned, mean_tpose)


def run_loop(model, cfg, skel, client, cal=None, device=None,
             seconds: float = 0.0, max_frames=None, out_path=None,
             record_path=None, metrics_path=None, hist=None, viewer=None,
             log=print):
    """Stream the client's readings through the full runner at 60 Hz until
    ``seconds`` have passed or ``max_frames`` frames were served (neither:
    until ^C). Each frame reads the client's latest reading, calibrates it
    with ``cal`` (None: already bone-frame), steps the runner and copies
    the pose to the host, timed into ``hist`` (a LatencyHistogram).
    ``out_path``: a jsonl line {"t", "qdq"} a frame; ``record_path``: the
    readings fed, as raw float32 (T, 72), a snapshot every 15 s and at the
    end; ``metrics_path``: the latency summary each second and at the end;
    ``viewer``: a viz/pybullet_viz.Viewer shown each frame's pose and SBP
    markers and, every 15 frames, the terrain.
    Returns (frames served, the latency summary)."""
    import torch

    from tip_tpu_torch import constants as cst
    from tip_tpu_torch import resolve_device
    from tip_tpu_torch.runtime import calibration as cal_lib
    from tip_tpu_torch.runtime import full_runner as FR
    from tip_tpu_torch.ops import kinematics as kin
    from tip_tpu_torch.runtime import runner as runner_lib
    from tip_tpu_torch.runtime import terrain as terrain_lib
    from tip_tpu_torch.utils.observability import (LatencyHistogram,
                                                   MetricsWriter)

    device = resolve_device(device)
    dtype = next(model.parameters()).dtype
    s_init = cal_lib.t_pose_init_state()
    # the fused kernels' weights, packed once; None for the plain forward
    packed = runner_lib.pack_fused_weights(model, cfg.base, dtype)

    def step(carry, reading):
        return FR.full_runner_step(
            model, carry, torch.as_tensor(reading, dtype=dtype,
                                          device=device),
            cfg, skel, packed_ws=packed)

    # the first frames build the kernels at first use: run them on a carry
    # of their own before the real-time loop starts
    log("warming up the runner step…")
    t0 = time.time()
    idle = np.zeros(72)
    idle[[0, 4, 8]] = 1.0
    warm = FR.full_runner_init(cfg, skel, s_init, dtype, device)
    for _ in range(cfg.base.imu_n_smooth + 1):
        warm, warm_out = step(warm, idle)
    warm_out["qdq"].cpu()
    log(f"warmed up in {time.time() - t0:.1f}s")
    carry = FR.full_runner_init(cfg, skel, s_init, dtype, device)

    hist = hist if hist is not None else LatencyHistogram()
    out_f = open(out_path, "w") if out_path else None
    metrics = MetricsWriter(metrics_path) if metrics_path else None
    rec = [] if record_path else None
    rec_flushed = 0
    t0 = time.time()
    last_report = t0
    t = 0
    try:
        while ((not seconds or time.time() - t0 < seconds)
               and (max_frames is None or t < max_frames)):
            tick = time.perf_counter()
            reading = client.current_reading()
            if cal is not None:
                reading = cal_lib.transform_reading(cal, reading)
            with hist.timed():
                carry, out = step(carry, reading)
                qdq = out["qdq"].cpu().numpy()
            if out_f:
                out_f.write(json.dumps({"t": t, "qdq": qdq.tolist()}) + "\n")
            if viewer is not None:
                viewer.set_pose(kin.our_pose_to_bullet(out["qdq"]).cpu()
                                .numpy())
                viewer.set_markers(out["viz_locs"].cpu().numpy())
                if t % 15 == 0:   # heightfield re-mesh (ref :293-305)
                    viewer.update_heightfield(
                        terrain_lib.height_field(carry.terrain).cpu().numpy(),
                        cfg.terrain.grid_size)
            if rec is not None:
                rec.append(reading.astype(np.float32))
                # persist a snapshot every 15 s (reference
                # live_demo_new.py:313-323 dumps a pkl every 15 s)
                if len(rec) - rec_flushed >= int(15.0 / cst.DT):
                    np.stack(rec).tofile(record_path)
                    rec_flushed = len(rec)
            if metrics is not None and time.time() - last_report >= 1.0:
                metrics.write(kind="latency", frame=t, **hist.summary())
                last_report = time.time()
            t += 1
            # 60 Hz pacing
            sleep = cst.DT - (time.perf_counter() - tick)
            if sleep > 0:
                time.sleep(sleep)
    except KeyboardInterrupt:
        pass
    finally:
        if out_f:
            out_f.close()
        if rec:
            np.stack(rec).tofile(record_path)
        summ = hist.summary()
        if metrics is not None:
            metrics.write(kind="final", frames=t, **summ)
            metrics.close()
        if summ.get("count"):
            log(f"frames={t} p50={summ['p50_ms']:.2f}ms "
                f"p99={summ['p99_ms']:.2f}ms")
    return t, summ


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=27015)
    ap.add_argument("--five_sbp", action="store_true")
    ap.add_argument("--with_acc_sum", action="store_true")
    ap.add_argument("--multi_sbp_correction", action="store_true")
    ap.add_argument("--skip_calibration", action="store_true",
                    help="treat incoming frames as already bone-frame")
    ap.add_argument("--seconds", type=float, default=0.0,
                    help="stop after N seconds (0 = until ^C)")
    ap.add_argument("--out", default=None, help="jsonl pose output path")
    ap.add_argument("--record", default=None,
                    help="record calibrated 72-float frames (raw f32) for "
                         "offline evaluation; a snapshot is persisted every "
                         "15 s like the reference (live_demo_new.py:313-323)")
    ap.add_argument("--metrics", default=None,
                    help="jsonl metrics output (latency percentiles every "
                         "second + final summary)")
    ap.add_argument("--tail_impl", default="auto",
                    choices=["auto", "plain", "fused"],
                    help="fused = the decode and tail kernels K2, K3 (5-SBP "
                         "layouts only). auto (default) = fused on the card "
                         "with 5 SBPs, plain otherwise")
    ap.add_argument("--viz", action="store_true",
                    help="show the live pose in the PyBullet viewer (needs "
                         "the pybullet wheel)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions)")
    return ap.parse_args(argv)


def build_runner(args):
    """The full runner of parsed arguments: (model, FullRunnerConfig,
    skeleton, device)."""
    from tip_tpu_torch import constants as cst
    from tip_tpu_torch import resolve_device
    from tip_tpu_torch.cli.evaluate import load_model
    from tip_tpu_torch.models import tip_model as M
    from tip_tpu_torch.ops import kinematics as kin
    from tip_tpu_torch.runtime import full_runner as FR
    from tip_tpu_torch.runtime import runner as runner_lib
    from tip_tpu_torch.runtime import terrain as terrain_lib

    device = resolve_device(args.device)
    n_sbps = 5 if args.five_sbp else 2
    model_cfg = M.ModelConfig(size_s=cst.state_dim(n_sbps),
                              with_acc_sum=args.with_acc_sum)
    model = load_model(args.ckpt, model_cfg, n_sbps, device)
    cfg = FR.FullRunnerConfig(
        base=runner_lib.RunnerConfig(model=model_cfg, n_sbps=n_sbps,
                                     with_acc_sum=args.with_acc_sum,
                                     tail_impl=args.tail_impl),
        terrain=terrain_lib.TerrainConfig(),
        multi_sbp=args.multi_sbp_correction)
    return model, cfg, kin.amass_skeleton(device=device), device


def main(argv=None):
    args = parse_args(argv)
    from tip_tpu_torch.runtime.imu_client import IMUClient

    model, cfg, skel, device = build_runner(args)
    viewer = None
    if args.viz:
        from tip_tpu_torch.viz import pybullet_viz, urdf_export
        viewer = pybullet_viz.Viewer(urdf_export.default_urdf_path(),
                                     compare_gt=False)
    client = IMUClient(args.host, args.port)
    client.start()
    try:
        while client.current_reading() is None:
            time.sleep(0.05)
        print("receiving frames")
        cal = None if args.skip_calibration else calibrate_client(client)
        return run_loop(model, cfg, skel, client, cal, device,
                        seconds=args.seconds, out_path=args.out,
                        record_path=args.record, metrics_path=args.metrics,
                        viewer=viewer)
    finally:
        client.stop()


if __name__ == "__main__":
    main()
