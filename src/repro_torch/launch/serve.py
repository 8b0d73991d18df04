"""Serving launcher: the streaming load-shedding service end to end.

One multi-camera ``ShedSession`` fronts the camera array behind the
full service skin (``repro_torch.serve.service``): timed per-camera
arrivals are coalesced into ``(C, T, H, W, 3)`` windows and scored +
admitted in one fused step per flush (the CUDA ingest kernel on the
card), admitted frames wait in the backpressured send queue, and a
token-gated sender drives a seeded mock of the paper's filter/DNN
backend. Every completion feeds the frame's *measured* latency into the
Eq. 17–20 control loop, and per-stage metrics (ingest fps, shed rate,
coalescer wait, queue depth, backend utilization, p50/p95/p99 E2E
latency, deadline violations) are exported as JSON/CSV.

The replay is paced by a virtual clock by default (deterministic given
``--seed``, runs as fast as the host allows); ``--wall-clock`` paces it
in real time, which is the service's production default. The session
runs on the CUDA card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --cams 8 --frames 300
  PYTHONPATH=src python -m repro_torch.launch.serve --cams 2 --frames 40 \\
      --device cpu
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from repro_torch.core import RED, Query, open_session, overall_qor
from repro_torch.data.pipeline import camera_array_records, scenario_records
from repro_torch.data.synthetic import generate_dataset
from repro_torch.serve import (
    Arrival,
    MockBackend,
    ServeService,
    VirtualClock,
    WallClock,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cams", type=int, default=8)
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--latency-bound", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for scenario generation and backend jitter")
    ap.add_argument("--tokens", type=int, default=1)
    ap.add_argument("--max-batch", type=int, default=8,
                    help="coalescer per-camera window size")
    ap.add_argument("--max-wait", type=float, default=0.05,
                    help="coalescer deadline (seconds)")
    ap.add_argument("--control-period", type=float, default=0.5)
    ap.add_argument("--real-backend", action="store_true",
                    help="a model forward as the backend (the LM backend "
                         "is not ported yet: asking for it is an error)")
    ap.add_argument("--backend-jitter", type=float, default=0.05,
                    help="mock backend multiplicative latency noise")
    ap.add_argument("--wall-clock", action="store_true",
                    help="pace the replay in real time (the production "
                         "clock) instead of the deterministic virtual one")
    ap.add_argument("--no-fused", action="store_true",
                    help="serve precomputed utilities via offer_batch "
                         "instead of raw frames via the fused step")
    ap.add_argument("--metrics-out", default="results/serve/metrics.json",
                    help="metrics JSON path (a .csv lands next to it)")
    ap.add_argument("--device", default=None,
                    help="torch device of the session (default: the CUDA "
                         "card; 'cpu' runs the plain PyTorch path)")
    args = ap.parse_args(argv)
    if args.real_backend:
        ap.error("--real-backend needs the LM backend, which the PyTorch "
                 "port does not have yet; use the mock backend")

    h, w = 48, 80
    query = Query.single(RED, latency_bound=args.latency_bound, fps=args.fps)

    print("generating scenarios...")
    scs = generate_dataset(range(args.seed, args.seed + args.cams + 3),
                           num_frames=args.frames, height=h, width=w)
    train, test = scs[:3], scs[3:]

    # one session fronts the whole camera array; fit() trains the query's
    # utility function and seeds the per-camera admission CDFs
    session = open_session(query, num_cameras=args.cams, frame_shape=(h, w),
                           device=args.device)
    train_recs = [r for i, s in enumerate(train)
                  for r in scenario_records(s, i, list(query.colors),
                                            fps=args.fps,
                                            device=session.device)]
    model = session.fit(np.stack([r.pf for r in train_recs]),
                        np.array([r.label for r in train_recs]))

    # the camera streams as timed arrivals; with the fused path the raw
    # RGB frames ride along and the service session scores them
    # in-dispatch (one fused step per coalesced window)
    streams = camera_array_records(test, list(query.colors), model=model,
                                   fps=args.fps, device=session.device)
    arrivals = []
    for c, stream in enumerate(streams):
        rgb = None if args.no_fused else test[c].frames_rgb()
        for t, r in enumerate(stream):
            arrivals.append(Arrival(
                t=r.t_gen, cam=r.cam_id, record=r, utility=float(r.utility),
                frame=None if rgb is None else rgb[t]))
    arrivals.sort(key=lambda a: a.t)

    backend = MockBackend(jitter=args.backend_jitter, seed=args.seed)
    clock = WallClock() if args.wall_clock else VirtualClock()
    service = ServeService(session, backend, clock=clock,
                           tokens=args.tokens, max_batch=args.max_batch,
                           max_wait=args.max_wait,
                           control_period=args.control_period)
    mode = "fused-step" if not args.no_fused else "offer_batch"
    print(f"serving {len(arrivals)} frames from {args.cams} cameras on "
          f"{session.device} ({mode}, "
          f"{'wall' if args.wall_clock else 'virtual'} clock)...")
    res = service.run(arrivals)

    objs = [r.objects for r in res.offered]
    lat = res.e2e_latencies()
    d = res.metrics["derived"]
    print(f"offered={d['offered']} processed={d['processed']} "
          f"shed_rate={d['shed_rate']:.2f} "
          f"backend_util={d['backend_utilization']:.2f}")
    print(f"QoR={overall_qor(objs, res.kept_mask):.3f} "
          f"violations={res.violations} "
          f"(rate {d['violation_rate']:.3f}) "
          f"p50={np.percentile(lat, 50)*1e3:.0f}ms "
          f"p99={np.percentile(lat, 99)*1e3:.0f}ms")
    out = Path(args.metrics_out)
    service.metrics.to_json(out)
    service.metrics.to_csv(out.with_suffix(".csv"))
    print(f"metrics -> {out} / {out.with_suffix('.csv')}")
    print()
    print(service.metrics.report("service metrics"))
    return res


if __name__ == "__main__":
    main()
