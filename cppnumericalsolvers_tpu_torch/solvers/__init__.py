from .lbfgs import Lbfgs, LbfgsInternals, LbfgsInternalsT, two_loop_direction

__all__ = ["Lbfgs", "LbfgsInternals", "LbfgsInternalsT", "two_loop_direction"]
