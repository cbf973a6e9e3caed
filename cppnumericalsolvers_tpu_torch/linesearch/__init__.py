from .armijo import ArmijoResult, armijo
from .dispatch import (
    LINE_SEARCHES,
    LineSearchResult,
    line_search_alpha,
    run_line_search,
)
from .hager_zhang import HagerZhangResult, hager_zhang
from .more_thuente import (
    DEFAULT_MAX_FEV,
    CstepState,
    MoreThuenteResult,
    cstep,
    more_thuente,
    trial_setup,
)

__all__ = [
    "ArmijoResult",
    "DEFAULT_MAX_FEV",
    "LINE_SEARCHES",
    "CstepState",
    "HagerZhangResult",
    "LineSearchResult",
    "MoreThuenteResult",
    "armijo",
    "cstep",
    "hager_zhang",
    "line_search_alpha",
    "more_thuente",
    "run_line_search",
    "trial_setup",
]
