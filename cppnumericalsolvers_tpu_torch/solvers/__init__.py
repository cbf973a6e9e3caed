from .bfgs import Bfgs, BfgsInternals
from .conjugate_gradient import CgInternals, ConjugateGradientDescent
from .gradient_descent import GradientDescent
from .lbfgs import Lbfgs, LbfgsInternals, LbfgsInternalsT, two_loop_direction
from .nelder_mead import NelderMead, NmInternals
from .newton import NewtonDescent, NewtonInternals
from .trust_region import TrInternals, TrustRegionNewton, solve_tr_subproblem

__all__ = [
    "Bfgs",
    "BfgsInternals",
    "CgInternals",
    "ConjugateGradientDescent",
    "GradientDescent",
    "Lbfgs",
    "LbfgsInternals",
    "LbfgsInternalsT",
    "NelderMead",
    "NewtonDescent",
    "NewtonInternals",
    "NmInternals",
    "TrInternals",
    "TrustRegionNewton",
    "solve_tr_subproblem",
    "two_loop_direction",
]
