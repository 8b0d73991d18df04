#!/usr/bin/env python3
"""Drive the PyTorch port's serve path once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — the card's name and count, and ``nvidia-smi``'s name and
   power limit (also printed raw on a line of its own);
2. build — builds the CUDA ingest kernel from ``src/`` with nvcc;
3. kernel — the CUDA ``ingest_batch`` against its plain PyTorch version
   on the card at the serve shape (8 cameras x 8 frames of 720x1280, two
   colors): bg_valid=True, and bg_valid=False with the bounding box;
   errors, differing count units, kernel / plain / bound milliseconds;
4. serve — ``open_session`` on the card, ``fit`` on PFs from
   ``session.ingest`` of a training clip, then per step
   ``report_backend_latency`` -> ``step(frames)`` -> ``next_frames``;
   the kernel's launch counter must rise on every step, and the card's
   utilities (read back from the CDF ring they were pushed to) replayed
   into a ``device="cpu"`` session started from the same state must give
   bit-identical decisions, evictions, rates, pops and queue lanes;
5. the ``kernels`` line, then the final ``{"ok": true, ...}`` line.

Frames are seeded synthetic traffic scenes (``data/synthetic.py``) at
90x160, upsampled x8 by nearest neighbour to 720x1280. Any failure raises
and exits non-zero; there is no CPU path.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
C, T, H, W, UP = 8, 8, 90, 160, 8          # 720x1280 after upsampling
TRAIN, STEPS, K_SEND = 16, 10, 40
HBM_BYTES_PER_S = 3.35e12                   # H100 SXM, data sheet
F32_OPS_PER_S = 67e12                       # float32 outside tensor cores


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def scenes(seed: int, n_frames: int):
    """(C, F, H, W, 3) float32 RGB and (C, F) labels for a red-or-yellow
    query, one seeded scenario per camera."""
    from repro_torch.data.synthetic import combined_label, generate_scenario
    scs = [generate_scenario(seed + c, num_frames=n_frames, height=H,
                             width=W, vehicle_rate=0.12)
           for c in range(C)]
    rgb = np.stack([sc.frames_rgb() for sc in scs]).astype(np.float32)
    labels = np.stack([combined_label(sc, ("red", "yellow"), "or")
                       for sc in scs])
    return rgb, labels


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.convert import state_from_numpy
    from repro_torch.core import Query, open_session
    from repro_torch.kernels.hsv_features import kernel, ref

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": name,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    kernel.build()
    ptxas = [ln.strip() for ln in kernel.BUILD.log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": round(kernel.BUILD.seconds, 3),
          "ptxas": ptxas})

    # -- inputs: seeded scenes, upsampled on the card ------------------------
    rgb_small, labels = scenes(1000, TRAIN + STEPS * T)
    small = torch.as_tensor(rgb_small, device=dev)

    def frames(t0: int, t1: int) -> torch.Tensor:
        x = small[:, t0:t1].repeat_interleave(UP, dim=2)
        return x.repeat_interleave(UP, dim=3).contiguous()

    q = Query.any_of("red", "yellow", latency_bound=1.0, fps=10.0)
    hr, nc, nb = q.hue_ranges, q.num_colors, q.bs * q.bv
    N = H * UP * W * UP

    # -- kernel vs plain at the serve shape ----------------------------------
    rng = np.random.default_rng(0)
    M = torch.as_tensor(rng.uniform(0, 1, (nc, nb)).astype(np.float32),
                        device=dev)
    norm = torch.as_tensor(rng.uniform(0.3, 1.0, nc).astype(np.float32),
                           device=dev)
    rgb = frames(TRAIN, TRAIN + T).reshape(C, T, N, 3)
    prev = frames(TRAIN - 1, TRAIN).reshape(C, N, 3)
    bg0 = (prev.amax(dim=-1)
           + torch.as_tensor(rng.normal(0, 3, (C, N)).astype(np.float32),
                             device=dev)).contiguous()
    gain0 = torch.as_tensor(rng.uniform(0.9, 1.1, C).astype(np.float32),
                            device=dev)
    results = {}
    for label, kw in (("bg_valid", dict(bg_valid=True, width=0)),
                      ("fresh_bbox", dict(bg_valid=False, width=W * UP))):
        args = (rgb, bg0, gain0, M, norm, hr)
        got = kernel.ingest_batch(*args, **kw)
        torch.cuda.synchronize()
        want = ref.ingest_batch_ref(*args, **kw)
        rep = kernel.compare_with_plain(got, want, M, norm)
        del got, want
        ms = cuda_ms(lambda: kernel.ingest_batch(*args, **kw), iters=20)
        plain_ms = cuda_ms(lambda: ref.ingest_batch_ref(*args, **kw),
                           iters=3, warmup=1)
        nbytes = kernel.bytes_moved(C, T, N, nc, nb, kw["bg_valid"],
                                    kw["width"])
        ops = kernel.OPS_PER_PIXEL * C * T * N
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        results[label] = dict(
            rep, ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            bytes=nbytes, ops=ops, device_launches_per_call=2 * T + 2)
        emit({"phase": "kernel", "config": label, "shape": [C, T, N, 3],
              **results[label]})
    del rgb, prev, bg0

    # -- the serve path ------------------------------------------------------
    sess = open_session(q, C, frame_shape=(H * UP, W * UP))
    pfs = [sess.ingest(frames(b, b + T)).pf for b in range(0, TRAIN, T)]
    pf = np.concatenate(pfs, axis=1).reshape(C * TRAIN, nc, q.bs, q.bv)
    sess.fit(pf, labels[:, :TRAIN].reshape(-1))
    replay = open_session(q, C, device="cpu", model=sess.model)
    replay.load_state(state_from_numpy(sess.state.as_dict(), "cpu"))
    Wc = sess.state.cdf_buf.shape[1]
    lat_rng = np.random.default_rng(1)
    step_ms, launches, admitted, shed, sent = [], [], 0, 0, 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernel.ingest_batch.launches = 0
    for i in range(STEPS):
        batch = frames(TRAIN + i * T, TRAIN + (i + 1) * T)
        lat = float(lat_rng.uniform(0.01, 0.03))    # backend s per frame
        pos = sess.state.cdf_pos.cpu().numpy()
        torch.cuda.synchronize()
        before = kernel.ingest_batch.launches
        sess.report_backend_latency(lat)
        t0 = time.perf_counter()
        res = sess.step(batch, tick=True)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        out = sess.next_frames(K_SEND)
        launches.append(kernel.ingest_batch.launches - before)
        if launches[-1] < 1:
            raise AssertionError(f"step {i}: the CUDA kernel did not launch")
        idx = (pos[:, None] + np.arange(T)[None, :]) % Wc
        util = np.take_along_axis(sess.state.cdf_buf.cpu().numpy(), idx, 1)
        if util.shape != (C, T) or not np.isfinite(util).all():
            raise AssertionError(f"step {i}: bad utilities {util}")
        if not set(np.unique(res.decisions).tolist()) <= {0, 1, 2}:
            raise AssertionError(f"step {i}: bad decision codes")
        replay.report_backend_latency(lat)
        rr = replay.step(utilities=util, tick=True)
        same = (np.array_equal(rr.decisions, res.decisions)
                and np.array_equal(rr.pushed_seq, res.pushed_seq)
                and np.array_equal(rr.target_drop_rate, res.target_drop_rate)
                and all(np.array_equal(a, b)
                        for a, b in zip(rr.evicted, res.evicted))
                and replay.next_frames(K_SEND) == out)
        if not same:
            raise AssertionError(f"step {i}: card and CPU control differ")
        admitted += int((res.decisions == 0).sum())
        shed += int((res.decisions > 0).sum())
        sent += len(out)
    main_launches = kernel.ingest_batch.launches
    peak = torch.cuda.max_memory_allocated(dev)
    dc, dr = sess.state.as_dict(), replay.state.as_dict()
    for leaf in ("threshold", "queue_cap", "q_util", "q_seq", "q_next_seq",
                 "cdf_buf", "cdf_counts", "proc_q"):
        if not np.array_equal(dc[leaf], dr[leaf]):
            raise AssertionError(f"state leaf {leaf}: card != CPU replay")
    emit({"phase": "serve", "cameras": C, "frames_per_step": T,
          "frame_shape": [H * UP, W * UP], "steps": STEPS,
          "step_ms": [round(x, 3) for x in step_ms],
          "step_ms_median": float(np.median(step_ms)),
          "kernel_launches_per_step": launches, "admitted": admitted,
          "shed": shed, "sent": sent, "queued_end": len(sess),
          "threshold_mean": float(dc["threshold"].mean()),
          "peak_device_bytes": int(peak), "cpu_replay_bit_identical": True})

    # -- where a step's time goes: a profiled window, then control alone ----
    from torch.profiler import ProfilerActivity, profile
    reps = 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            sess.report_backend_latency(0.02)
            sess.step(batch, tick=True)
            sess.next_frames(K_SEND)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []            # device-side events only: aten rows repeat them
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    dev_us = sum(r[0] for r in rows)
    ours = sum(r[0] for r in rows if r[1].startswith(
        ("frame_kernel", "gain_kernel", "init_kernel", "finalize_kernel")))
    control = []
    for _ in range(10):
        t0 = time.perf_counter()
        sess.step(utilities=util, tick=True)
        torch.cuda.synchronize()
        control.append((time.perf_counter() - t0) * 1e3)
    emit({"phase": "profile", "steps": reps,
          "wall_ms_per_step_profiled": wall * 1e3 / reps,
          "device_ms_per_step": dev_us / 1e3 / reps,
          "ingest_kernel_device_ms_per_step": ours / 1e3 / reps,
          "device_busy_share": dev_us / 1e6 / wall if dev_us else None,
          "device_kernels_per_step": sum(r[2] for r in rows) / reps,
          "top": [[k[:70], us / 1e3 / reps, n / reps]
                  for us, k, n in rows[:12]],
          "control_only_step_ms": sorted(control)})

    main = results["bg_valid"]
    emit({"kernels": [{
        "name": "ingest_batch", "route": "cuda",
        "source": "src/repro_torch/kernels/hsv_features/csrc/ingest.cu",
        "replaces": "src/repro/kernels/hsv_features/kernel.py:360",
        "launches": main_launches, "max_abs_err": main["max_abs_err"],
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
