"""torch_ops_device_ms: device milliseconds a step of every operation
that is not the hand-written ingest kernel: the control plane, the
cascade's glue and the frames' dtype conversion."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.device:
        return None
    return tr.device_seconds(lambda n: "ingest_kernel" not in n) * 1e3 / tr.steps
