from .lbfgs import Lbfgs, LbfgsInternals

__all__ = ["Lbfgs", "LbfgsInternals"]
