from .flat_solve import flat_lbfgs_solve, flat_trip, flat_trip_reference
from .fused_linesearch import (
    batched_more_thuente,
    mt_trip,
    mt_trip_reference,
)
from .fused_step import (
    lbfgs_epilogue,
    lbfgs_epilogue_reference,
    lbfgs_prologue,
    lbfgs_prologue_reference,
)

__all__ = [
    "batched_more_thuente",
    "flat_lbfgs_solve",
    "flat_trip",
    "flat_trip_reference",
    "lbfgs_epilogue",
    "lbfgs_epilogue_reference",
    "lbfgs_prologue",
    "lbfgs_prologue_reference",
    "mt_trip",
    "mt_trip_reference",
]
