from repro_torch.sharding.api import (
    ParamSpec,
    constrain,
    materialize,
    num_params,
    tree_map_specs,
)

__all__ = [
    "ParamSpec",
    "constrain",
    "materialize",
    "num_params",
    "tree_map_specs",
]
