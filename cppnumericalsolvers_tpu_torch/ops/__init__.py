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
from .fused_step_t import (
    history_rows_to_t,
    history_t_to_rows,
    lbfgs_prologue_t,
    lbfgs_prologue_t_reference,
    make_history_t,
)
from .two_loop import (
    lbfgs_push_and_direction,
    lbfgs_push_and_direction_reference,
    two_loop_direction,
    two_loop_direction_reference,
)

__all__ = [
    "batched_more_thuente",
    "flat_lbfgs_solve",
    "flat_trip",
    "flat_trip_reference",
    "history_rows_to_t",
    "history_t_to_rows",
    "lbfgs_epilogue",
    "lbfgs_epilogue_reference",
    "lbfgs_prologue",
    "lbfgs_prologue_reference",
    "lbfgs_prologue_t",
    "lbfgs_prologue_t_reference",
    "lbfgs_push_and_direction",
    "lbfgs_push_and_direction_reference",
    "make_history_t",
    "mt_trip",
    "mt_trip_reference",
    "two_loop_direction",
    "two_loop_direction_reference",
]
