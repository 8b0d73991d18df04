"""step_p95_ms: the 95th percentile, over every step of the window, of
the host clock from the call of ``step`` to its return (``step`` returns
host decisions, so it ends in a sync)."""
import numpy as np


def read(rec):
    return float(np.percentile(np.asarray(rec.window.step_s), 95)) * 1e3
