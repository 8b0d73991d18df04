"""The system under test: a ``repro_torch`` shed session, opened on the
cell's configuration with the benchmark's inputs. This is the only
module of the benchmark that imports the program."""
from __future__ import annotations

from .inputs import Inputs


def open_program(cfg, inputs: Inputs, cameras: int, device):
    """``open_session`` as the configuration states it: the query, the
    frame shape, the session's settings, the benchmark's utility model
    and CDF history, and with ``cascade`` an ``MLPScorer`` on the
    benchmark's weights behind a ``Cascade``."""
    import numpy as np

    from repro_torch.core import Query, open_session
    from repro_torch.core.utility import UtilityModel

    q = cfg["query"]
    query = Query(colors=tuple(q["colors"]), op=q["op"],
                  latency_bound=q["latency_bound"], fps=q["fps"], bs=q["bs"],
                  bv=q["bv"], alpha=q["alpha"], threshold=q["threshold"],
                  use_foreground=q["use_foreground"])
    model = UtilityModel(query.colors, inputs.M_pos,
                         np.zeros_like(inputs.M_pos), inputs.norm, q["op"])
    s = cfg["session"]
    kw = dict(frame_shape=tuple(cfg["frame_shape"]), model=model,
              train_utilities=inputs.train_utilities,
              cdf_window=s["cdf_window"], queue_size=s["queue_size"],
              queue_capacity=s["queue_capacity"],
              quantile_bins=s["quantile_bins"],
              quantile_range=tuple(s["quantile_range"]),
              ewma_alpha=s["ewma_alpha"], ewma_alpha_up=s["ewma_alpha_up"],
              min_proc=s["min_proc"], device=device)
    cs = cfg.get("cascade")
    if cs:
        from repro_torch.cascade import Cascade, MLPScorer
        kw.update(cascade=Cascade(MLPScorer(params=dict(inputs.scorer),
                                            roi_size=cs["roi_size"]),
                                  gate_fraction=cs["gate_fraction"],
                                  window=cs["window"]),
                  s2_quantile_range=tuple(cs["s2_quantile_range"]))
    return open_session(query, cameras, **kw)
