"""scorer_ms: host-clock milliseconds a call of the stage-2 scorer's
``score`` (ROI gather and MLP), the span ended by a sync; recorded by the
harness in the traced run, outside the profiled stretch."""


def read(rec):
    spans = rec.window.spans.get("scorer")
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e3
