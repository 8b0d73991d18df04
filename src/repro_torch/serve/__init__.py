# Serving layer: the offline discrete-event simulator (synthetic
# backend latencies) and the streaming service (async ingest
# coalescing, backpressured transport, measured backend latencies,
# per-stage metrics). Both drive the same ShedSession serving surface,
# so QoR/violation results are directly comparable.
from repro_torch.serve.clock import Clock, VirtualClock, WallClock
from repro_torch.serve.fault import (
    BackendError,
    BackendTimeout,
    BackendUnavailable,
    BreakerConfig,
    CircuitBreaker,
    DegradedConfig,
    FaultyBackend,
    ResilienceConfig,
    RetryPolicy,
)
from repro_torch.serve.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    StateGauge,
)
from repro_torch.serve.service import (
    Arrival,
    IngestCoalescer,
    ServeService,
    ServiceResult,
    ServedFrame,
    arrivals_from_records,
)
from repro_torch.serve.simulator import (
    BackendProfile,
    PipelineSimulator,
    ProcessedFrame,
    SimResult,
)
from repro_torch.serve.transport import (
    Backend,
    CallableBackend,
    MockBackend,
    SenderWorker,
    as_backend,
)

__all__ = [
    "Arrival", "Backend", "BackendError", "BackendProfile", "BackendTimeout",
    "BackendUnavailable", "BreakerConfig", "CallableBackend",
    "CircuitBreaker", "Clock", "Counter", "DegradedConfig", "FaultyBackend",
    "Gauge", "Histogram", "IngestCoalescer", "MetricsRegistry",
    "MockBackend", "PipelineSimulator", "ProcessedFrame", "ResilienceConfig",
    "RetryPolicy", "SenderWorker", "ServeService", "ServiceResult",
    "ServedFrame", "SimResult", "StateGauge", "VirtualClock", "WallClock",
    "arrivals_from_records", "as_backend",
]
