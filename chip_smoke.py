#!/usr/bin/env python3
"""Drive the PyTorch port's serve path once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — the card's name and count, and ``nvidia-smi``'s name and
   power limit (also printed raw on a line of its own);
2. build — builds the CUDA kernels (``ingest.cu``, ``hist.cu``) from
   ``src/`` with nvcc, one process per source, started together;
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
5. profile — a profiled window of serve steps, then the control plane
   alone;
6. hist — the CUDA ``hsv_hist_batch`` against its plain version at the
   serve shape (64 frames of 720x1280, two colors), with the foreground
   mask of ``data/background.py``'s ``batch_foreground`` as a bool mask
   and as float 0/1 weights; then the staged entry point ``batch_pf``
   over those frames (one kernel call) against the plain path;
7. service — ``ServeService.run`` (virtual clock, seeded mock backend,
   the launcher's coalescer settings) over a card session fitted as
   ``repro_torch.launch.serve`` fits one, 8 cameras x 48 frames of
   720x1280 through the fused ``step(frames=...)`` dispatch, timed per
   dispatch; the same arrivals with the card's precomputed utilities and
   no frames, served through ``offer_batch`` by a ``device="cpu"``
   session started from the same state, must keep the same frames on the
   same timeline with the same counters;
8. the ``kernels`` line, then the final ``{"ok": true, ...}`` line.

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
SVC_CAMS, SVC_FRAMES, SVC_TRAIN = 8, 48, 3   # service phase: the launcher's
SVC_FPS, SVC_BOUND = 30.0, 0.5               # query, fps and coalescer
SVC_MAX_BATCH, SVC_MAX_WAIT = 8, 0.05
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


class Upsampled:
    """A synthetic scenario whose ``frames_rgb`` are its frames upsampled
    x UP by nearest neighbour (720x1280 from 90x160); labels, objects and
    the rest are the scenario's own."""

    def __init__(self, sc):
        self._sc = sc

    def __getattr__(self, name):
        return getattr(self._sc, name)

    def frames_rgb(self) -> np.ndarray:
        x = self._sc.frames_rgb().astype(np.float32)
        return np.repeat(np.repeat(x, UP, axis=1), UP, axis=2)


class TimedSession:
    """The session as the service sees it, with ``step`` timed on the
    host clock up to ``torch.cuda.synchronize()`` (the copy of the
    window's frames to the card included) and the ingest kernel's launch
    counter read around every fused dispatch."""

    def __init__(self, sess, kernel):
        self._sess, self._kernel = sess, kernel
        self.step_ms, self.launches = [], []

    def __getattr__(self, name):
        return getattr(self._sess, name)

    def __len__(self):
        return len(self._sess)

    def step(self, *a, **k):
        import torch
        torch.cuda.synchronize()
        before = self._kernel.ingest_batch.launches
        t0 = time.perf_counter()
        res = self._sess.step(*a, **k)
        torch.cuda.synchronize()
        self.step_ms.append((time.perf_counter() - t0) * 1e3)
        self.launches.append(self._kernel.ingest_batch.launches - before)
        return res


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
          "libraries": sorted(kernel.BUILD.libs), "ptxas": ptxas})

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

    del sess, replay
    hist = hist_phase(dev, frames, hr, nc, nb, N, kernel, ref)
    service_phase(dev, kernel, state_from_numpy)

    main = results["bg_valid"]
    emit({"kernels": [{
        "name": "ingest_batch", "route": "cuda",
        "source": "src/repro_torch/kernels/hsv_features/csrc/ingest.cu",
        "replaces": "src/repro/kernels/hsv_features/kernel.py:360",
        "launches": main_launches, "max_abs_err": main["max_abs_err"],
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None}, {
        "name": "hsv_hist", "route": "cuda",
        "source": "src/repro_torch/kernels/hsv_features/csrc/hist.cu",
        "replaces": "src/repro/kernels/hsv_features/kernel.py:146",
        "launches": hist["launches"], "max_abs_err": hist["max_abs_err"],
        "ms": hist["ms"], "plain_ms": hist["plain_ms"],
        "bound_ms": hist["bound_ms"], "bound_by": hist["bound_by"],
        "library_ms": None}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


def hist_phase(dev, frames, hr, nc, nb, N, kernel, ref) -> dict:
    """The histogram kernel against its plain version at the serve shape,
    with a bool mask and with float 0/1 weights, then ``batch_pf`` (its
    path: one kernel call for all frames) against the plain path."""
    import torch
    from repro_torch.core.colors import COLORS, rgb_to_hsv_np
    from repro_torch.data.background import batch_foreground
    from repro_torch.kernels.hsv_features.ops import batch_pf
    from repro_torch.kernels.hsv_features.ref import pf_from_counts

    F = C * T
    rgb = frames(TRAIN, TRAIN + T).reshape(F, N, 3)
    # The foreground of the legacy host model (per-pixel EMA, median gain)
    # over each camera's last 2T frames, computed at 90x160 and upsampled
    # like the frames: repeating every pixel UP*UP times changes neither
    # a per-pixel comparison nor a median, so this is the mask of the
    # 720x1280 frames.
    small, _ = scenes(1000, TRAIN + T)
    masks = np.stack([batch_foreground(rgb_to_hsv_np(small[c, TRAIN - T:]))
                      [T:] for c in range(C)])                # (C, T, H, W)
    fg_small = torch.as_tensor(masks, device=dev)
    fg = fg_small.repeat_interleave(UP, dim=2).repeat_interleave(
        UP, dim=3).reshape(F, N).contiguous()
    out = {}
    for label, w in (("bool", fg), ("float", fg.to(torch.float32))):
        got = kernel.hsv_hist_batch(rgb, w, hr)
        torch.cuda.synchronize()
        want = ref.hsv_hist_ref(rgb, w, hr)
        rep = kernel.compare_hist_with_plain(got, want, w)
        if rep["count_units_differing"] != 0:
            raise AssertionError(f"hsv_hist ({label}): "
                                 f"{rep['count_units_differing']} count "
                                 "units differ from the plain version")
        ms = cuda_ms(lambda: kernel.hsv_hist_batch(rgb, w, hr), iters=20)
        plain_ms = cuda_ms(lambda: ref.hsv_hist_ref(rgb, w, hr), iters=3,
                           warmup=1)
        nbytes = kernel.hist_bytes_moved(F, N, nc, nb, w.element_size())
        ops = kernel.HIST_OPS_PER_PIXEL * F * N
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        out[label] = dict(
            rep, ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            bytes=nbytes, ops=ops, foreground_share=float(w.float().mean()))
        if label == "bool":
            want_counts, want_totals, want_fgtot = want
        del got, want
    # the staged entry point, driven once with the counter at 0
    colors = [COLORS["red"], COLORS["yellow"]]
    rgb_hw = rgb.reshape(F, H * UP, W * UP, 3)
    fg_hw = fg.reshape(F, H * UP, W * UP)
    kernel.hsv_hist_batch.launches = 0
    pf, hf = batch_pf(rgb_hw, fg_hw, colors)
    torch.cuda.synchronize()
    launches = kernel.hsv_hist_batch.launches
    if launches < 1:
        raise AssertionError("batch_pf did not launch the hsv_hist kernel")
    pf_plain = pf_from_counts(want_counts, want_totals)
    hf_plain = want_totals / torch.clamp_min(want_fgtot, 1.0)[:, None]
    pf_err = float((pf - pf_plain).abs().max())
    hf_err = float((hf - hf_plain).abs().max())
    if not (pf_err <= 1e-6 and hf_err <= 1e-6):
        raise AssertionError(f"batch_pf vs plain: pf {pf_err}, hf {hf_err}")
    if not (torch.isfinite(pf).all() and pf.shape == (F, 2, 8, 8)):
        raise AssertionError("batch_pf: bad PF matrices")
    emit({"phase": "hist", "shape": [F, N, 3], **{
        f"{label}_{k}": v for label, r in out.items() for k, v in r.items()},
        "batch_pf_launches": launches, "batch_pf_pf_err": pf_err,
        "batch_pf_hf_err": hf_err})
    return dict(out["bool"], launches=launches)


def service_phase(dev, kernel, state_from_numpy) -> None:
    """``ServeService.run`` over a card session with raw 720x1280 frames,
    held to a CPU replay of the same arrivals through ``offer_batch``."""
    import torch
    from repro_torch.core import RED, Query, open_session, overall_qor
    from repro_torch.data.pipeline import (
        camera_array_records,
        scenario_records,
    )
    from repro_torch.data.synthetic import generate_dataset
    from repro_torch.serve import Arrival, MockBackend, ServeService, \
        VirtualClock

    h, w = H * UP, W * UP
    q = Query.single(RED, latency_bound=SVC_BOUND, fps=SVC_FPS)
    # the serve phase's vehicle rate: at the default 0.05 the 3 training
    # clips of 48 frames hold no positive label to fit the query on
    scs = [Upsampled(sc) for sc in generate_dataset(
        range(2000, 2000 + SVC_CAMS + SVC_TRAIN), num_frames=SVC_FRAMES,
        height=H, width=W, vehicle_rate=0.12)]
    train, test = scs[:SVC_TRAIN], scs[SVC_TRAIN:]
    sess = open_session(q, num_cameras=SVC_CAMS, frame_shape=(h, w))
    recs = [r for i, sc in enumerate(train)
            for r in scenario_records(sc, i, list(q.colors), fps=SVC_FPS)]
    model = sess.fit(np.stack([r.pf for r in recs]),
                     np.array([r.label for r in recs]))
    replay = open_session(q, SVC_CAMS, device="cpu", model=model)
    replay.load_state(state_from_numpy(sess.state.as_dict(), "cpu"))
    streams = camera_array_records(test, list(q.colors), model=model,
                                   fps=SVC_FPS)
    fused, scored = [], []
    for c, stream in enumerate(streams):
        rgb = test[c].frames_rgb()
        for t, r in enumerate(stream):
            fused.append(Arrival(t=r.t_gen, cam=r.cam_id, record=r,
                                 frame=rgb[t]))
            scored.append(Arrival(t=r.t_gen, cam=r.cam_id, record=r,
                                  utility=float(r.utility)))
    for a in (fused, scored):
        a.sort(key=lambda x: x.t)
    if not all(np.isfinite(a.utility) for a in scored):
        raise AssertionError("service: non-finite utilities")

    def service(s):
        return ServeService(s, MockBackend(seed=0), clock=VirtualClock(),
                            max_batch=SVC_MAX_BATCH, max_wait=SVC_MAX_WAIT)

    timed = TimedSession(sess, kernel)
    torch.cuda.synchronize()
    kernel.ingest_batch.launches = 0
    t0 = time.perf_counter()
    res = service(timed).run(fused)
    wall = time.perf_counter() - t0
    launches = kernel.ingest_batch.launches
    cnt = res.metrics["counters"]
    n_fused = cnt.get("dispatch.fused", 0)
    if n_fused < 1 or n_fused != len(timed.step_ms):
        raise AssertionError(f"service: {n_fused} fused dispatches, "
                             f"{len(timed.step_ms)} timed steps")
    if cnt.get("dispatch.batched", 0) or cnt.get("dispatch.sequential", 0):
        raise AssertionError("service: a window left the fused path")
    if min(timed.launches) < 1:
        raise AssertionError("service: a fused dispatch launched no kernel")
    cpu = service(replay).run(scored)

    def timeline(r):
        return [(p.record.cam_id, p.record.frame_idx, p.t_sent, p.t_done,
                 p.backend_latency) for p in r.processed]

    if res.kept_mask != cpu.kept_mask or timeline(res) != timeline(cpu):
        raise AssertionError("service: card run and CPU offer_batch replay "
                             "kept different frames")
    if sess.stats.__dict__ != replay.stats.__dict__:
        raise AssertionError(f"service: counters differ {sess.stats} vs "
                             f"{replay.stats}")
    for k in ("shed.admission", "shed.queue", "sender.sent",
              "sender.expired", "backend.done"):
        if cnt.get(k, 0) != cpu.metrics["counters"].get(k, 0):
            raise AssertionError(f"service: counter {k} differs")
    lat = res.e2e_latencies()
    d = res.metrics["derived"]
    emit({"phase": "service", "cameras": SVC_CAMS, "frames": SVC_FRAMES,
          "frame_shape": [h, w], "fps": SVC_FPS,
          "max_batch": SVC_MAX_BATCH, "max_wait_s": SVC_MAX_WAIT,
          "dispatch_fused": int(n_fused),
          "train_positive_labels": int(sum(r.label for r in recs)),
          "window_frames": res.metrics["histograms"][
              "coalescer.batch_frames"],
          "dispatch_ms": [round(x, 3) for x in timed.step_ms],
          "dispatch_ms_median": float(np.median(timed.step_ms)),
          "ingest_launches_per_dispatch": sorted(set(timed.launches)),
          "ingest_launches": launches, "run_wall_s": wall,
          "offered": d["offered"], "processed": d["processed"],
          "shed_rate": d["shed_rate"],
          "qor": overall_qor([r.objects for r in res.offered],
                             res.kept_mask),
          "violations": res.violations,
          "e2e_virtual_p50_s": float(np.percentile(lat, 50)),
          "e2e_virtual_p99_s": float(np.percentile(lat, 99)),
          "cpu_offer_batch_replay_equal": True})


if __name__ == "__main__":
    sys.exit(main())
