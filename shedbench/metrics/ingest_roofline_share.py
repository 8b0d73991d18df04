"""ingest_roofline_share: the fused ingest's least time over its device
time a step. The least time is the larger of its least bytes over the
card's HBM rate and its operations over the float32 rate, both counted
by ``yardstick.counting`` from the cell's shapes with the frames as the
uint8 pixels handed over."""
from yardstick import counting, peaks


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    dev_s = tr.device_seconds(lambda n: "ingest_kernel" in n) / tr.steps
    if dev_s <= 0:
        return None
    sh = rec.shapes
    least, _ = counting.least_seconds(
        counting.ingest_bytes(sh["C"], sh["T"], sh["N"], sh["nc"], sh["nb"],
                              sh["width"]),
        counting.ingest_ops(sh["C"], sh["T"], sh["N"]),
        peaks.HBM_BYTES_PER_S, peaks.FP32_OPS_PER_S)
    return 100.0 * least / dev_s
