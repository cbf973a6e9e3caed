from .dispatch import LINE_SEARCHES, LineSearchResult, run_line_search
from .more_thuente import (
    DEFAULT_MAX_FEV,
    CstepState,
    MoreThuenteResult,
    cstep,
    more_thuente,
    trial_setup,
)

__all__ = [
    "DEFAULT_MAX_FEV",
    "LINE_SEARCHES",
    "CstepState",
    "LineSearchResult",
    "MoreThuenteResult",
    "cstep",
    "more_thuente",
    "run_line_search",
    "trial_setup",
]
