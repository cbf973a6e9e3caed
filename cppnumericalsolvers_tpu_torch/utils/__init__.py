"""Helpers shared by the port's solvers and drivers."""

from .linalg import condition_test_enabled, frobenius_condition

__all__ = ["condition_test_enabled", "frobenius_condition"]
