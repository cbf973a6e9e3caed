from .more_thuente import DEFAULT_MAX_FEV, CstepState, cstep, trial_setup

__all__ = ["DEFAULT_MAX_FEV", "CstepState", "cstep", "trial_setup"]
