"""Multi-device batched solving over ``torch.distributed`` (the batch split
over ranks, or each instance's n split over a model axis)."""

from .model_sharded import minimize_model_sharded
from .sharded import (
    aggregate_metrics,
    initialize_distributed,
    make_mesh,
    minimize_sharded,
)

__all__ = [
    "aggregate_metrics",
    "initialize_distributed",
    "make_mesh",
    "minimize_model_sharded",
    "minimize_sharded",
]
