"""launches_per_step: device operations (kernels, copies, memsets) a
closed-loop iteration, from the profiler's trace of the traced stretch."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.device:
        return None
    return len(tr.device) / tr.steps
