"""The serve service's metrics registry: ``repro_torch.metrics``, named
here too (the registry lives at the package's top so that the session in
``core/`` holds one without importing this package)."""
from repro_torch.metrics import (  # noqa: F401
    PCTS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    StateGauge,
)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "StateGauge"]
