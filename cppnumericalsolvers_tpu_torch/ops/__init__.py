from .flat_solve import flat_lbfgs_solve, flat_trip, flat_trip_reference

__all__ = ["flat_lbfgs_solve", "flat_trip", "flat_trip_reference"]
