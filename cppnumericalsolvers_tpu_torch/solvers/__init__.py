from .augmented_lagrangian import (
    AlResult,
    AugmentedLagrangeState,
    AugmentedLagrangian,
)
from .bfgs import Bfgs, BfgsInternals
from .conjugate_gradient import CgInternals, ConjugateGradientDescent
from .gradient_descent import GradientDescent
from .lbfgs import Lbfgs, LbfgsInternals, LbfgsInternalsT, two_loop_direction
from .lbfgsb import Lbfgsb, LbfgsbInternals, projected_gradient_inf_norm
from .nelder_mead import NelderMead, NmInternals
from .newton import NewtonDescent, NewtonInternals
from .trust_region import TrInternals, TrustRegionNewton, solve_tr_subproblem

__all__ = [
    "AlResult",
    "AugmentedLagrangeState",
    "AugmentedLagrangian",
    "Bfgs",
    "BfgsInternals",
    "CgInternals",
    "ConjugateGradientDescent",
    "GradientDescent",
    "Lbfgs",
    "LbfgsInternals",
    "LbfgsInternalsT",
    "Lbfgsb",
    "LbfgsbInternals",
    "NelderMead",
    "NewtonDescent",
    "NewtonInternals",
    "NmInternals",
    "TrInternals",
    "TrustRegionNewton",
    "projected_gradient_inf_norm",
    "solve_tr_subproblem",
    "two_loop_direction",
]
