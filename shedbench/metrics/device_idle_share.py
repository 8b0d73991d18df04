"""device_idle_share: the share of the traced stretch's wall time in
which no device operation ran (1 - union of busy intervals / stretch)."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
