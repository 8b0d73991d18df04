# The paper's primary contribution on PyTorch: utility function, CDF
# threshold mapping, control loop, utility-ordered bounded queue, QoR
# metrics, unified behind the multi-camera session API
# (repro_torch.core.session).
from repro_torch.core.colors import BLUE, COLORS, GREEN, RED, YELLOW, Color
from repro_torch.core.control import ControlLoop, LatencyInputs
from repro_torch.core.qor import drop_rate, overall_qor, per_object_qor
from repro_torch.core.shed_queue import UtilityQueue
from repro_torch.core.shedder import LoadShedder, ShedderStats
from repro_torch.core.threshold import UtilityCDF
from repro_torch.core.utility import (
    B_S,
    B_V,
    UtilityModel,
    batch_utilities,
    pixel_fraction_matrix,
    train_utility_model,
)

# The session module imports the ingest kernel package, which imports
# core.utility: its names load on first use, so that importing any kernel
# module first does not run into a partly initialised package.
_SESSION_NAMES = ("IngestResult", "Query", "SessionState", "ShedSession",
                  "StepResult", "open_session")


def __getattr__(name):
    if name in _SESSION_NAMES:
        from repro_torch.core import session
        return getattr(session, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "BLUE", "COLORS", "GREEN", "RED", "YELLOW", "Color",
    "ControlLoop", "LatencyInputs",
    "drop_rate", "overall_qor", "per_object_qor",
    "UtilityQueue", "LoadShedder", "ShedderStats", "UtilityCDF",
    "B_S", "B_V", "UtilityModel", "batch_utilities",
    "pixel_fraction_matrix", "train_utility_model",
    "IngestResult", "Query", "SessionState", "ShedSession", "StepResult",
    "open_session",
]
