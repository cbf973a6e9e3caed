"""Moré–Garbow–Hillstrom benchmark suite.

PyTorch counterpart of ``cppnumericalsolvers_tpu/models/suite.py``: the 35
MGH functions as objectives on one ``(n,)`` tensor (batched by
``torch.func.vmap``), their standard starts and, where known, the optimal
value, and the 376-instance benchmark built from them (58 distinct
problems: the full set at standard dimensions plus dimension sweeps of the
variable-dimension families, 6-7 starts each).  The reference's headline
claim is 95% of those instances converged (its README.md:6-11).

Each entry is ``SuiteProblem(name, objective, x0, f_star)``.  ``f_star`` of
``None`` means the success check falls back to the gradient criterion.
Starts are numpy arrays made by the same generator calls as the JAX
package's, so the two packages' instances are equal bit for bit.

Constant vectors of a function (data, abscissae, index ranges) are made
once per device and dtype and cached, so an evaluation on the card copies
nothing from the host.  No function branches in Python on a value, so
``vmap`` batches every one.

Standard starts and residual definitions follow Moré, Garbow & Hillstrom,
"Testing Unconstrained Optimization Software", TOMS 7(1), 1981.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.objective import Objective

__all__ = [
    "SuiteProblem",
    "mgh_suite",
    "mgh_benchmark_instances",
    "success_mask",
    "suite_with_multistarts",
]


class SuiteProblem(NamedTuple):
    name: str
    objective: Objective
    x0: np.ndarray
    f_star: float | None  # known optimum value (from the standard start)


def _obj(fn):
    return Objective(fn, mode="second")


def success_mask(problem, f, ginf, xinf):
    """The reference's per-instance success contract (progress.h:383-427;
    ``bench.py``'s ``success_mask``): ``f`` within 1e-4 of ``f_star``
    (relative above 1), or ``|g|_inf < 1e-5 max(1, |x|_inf)``, and ``f``
    finite.  numpy arrays of the final value and the infinity norms of the
    gradient and the iterate in, a bool array out."""
    grad_ok = ginf < 1e-5 * np.maximum(1.0, xinf)
    if problem.f_star is not None:
        f_ok = f <= problem.f_star + 1e-4 * max(1.0, abs(problem.f_star))
    else:
        f_ok = np.zeros_like(grad_ok, dtype=bool)
    return np.isfinite(f) & (grad_ok | f_ok)


def _sumsq(r):
    return torch.sum(r * r)


# -- constants, made once per (device, dtype) ---------------------------------

_DATA = {
    "bard": [0.14, 0.18, 0.22, 0.25, 0.29, 0.32, 0.35, 0.39, 0.37, 0.58,
             0.73, 0.96, 1.34, 2.10, 4.39],
    "gaussian": [0.0009, 0.0044, 0.0175, 0.0540, 0.1295, 0.2420, 0.3521,
                 0.3989, 0.3521, 0.2420, 0.1295, 0.0540, 0.0175, 0.0044,
                 0.0009],
    "meyer": [34780.0, 28610.0, 23650.0, 19630.0, 16370.0, 13720.0,
              11540.0, 9744.0, 8261.0, 7030.0, 6005.0, 5147.0, 4427.0,
              3820.0, 3307.0, 2872.0],
    "kowalik_y": [0.1957, 0.1947, 0.1735, 0.1600, 0.0844, 0.0627, 0.0456,
                  0.0342, 0.0323, 0.0235, 0.0246],
    "kowalik_u": [4.0, 2.0, 1.0, 0.5, 0.25, 0.167, 0.125, 0.1, 0.0833,
                  0.0714, 0.0625],
    "osborne1": [0.844, 0.908, 0.932, 0.936, 0.925, 0.908, 0.881, 0.850,
                 0.818, 0.784, 0.751, 0.718, 0.685, 0.658, 0.628, 0.603,
                 0.580, 0.558, 0.538, 0.522, 0.506, 0.490, 0.478, 0.467,
                 0.457, 0.448, 0.438, 0.431, 0.424, 0.420, 0.414, 0.411,
                 0.406],
    "osborne2": [1.366, 1.191, 1.112, 1.013, 0.991, 0.885, 0.831, 0.847,
                 0.786, 0.725, 0.746, 0.679, 0.608, 0.655, 0.616, 0.606,
                 0.602, 0.626, 0.651, 0.724, 0.649, 0.649, 0.694, 0.644,
                 0.624, 0.661, 0.612, 0.558, 0.533, 0.495, 0.500, 0.423,
                 0.395, 0.375, 0.372, 0.391, 0.396, 0.405, 0.428, 0.429,
                 0.523, 0.562, 0.607, 0.653, 0.672, 0.708, 0.633, 0.668,
                 0.645, 0.632, 0.591, 0.559, 0.597, 0.625, 0.739, 0.710,
                 0.729, 0.720, 0.636, 0.581, 0.428, 0.292, 0.162, 0.098,
                 0.054],
    "beale": [1.5, 2.25, 2.625],
}


@functools.lru_cache(maxsize=None)
def _const(key, device, dtype):
    """A data vector of ``_DATA`` (rounded from float64 to ``dtype``, as
    ``jnp.asarray(np_array, dtype)`` rounds it) on ``device``."""
    return torch.tensor(np.asarray(_DATA[key]), dtype=torch.float64).to(
        device=device, dtype=dtype)


@functools.lru_cache(maxsize=None)
def _arange(start, stop, device, dtype):
    return torch.arange(start, stop, dtype=dtype, device=device)


def _data(key, x):
    return _const(key, x.device, x.dtype)


def _range(start, stop, x):
    """``jnp.arange(start, stop, dtype=x.dtype)`` on ``x``'s device."""
    return _arange(start, stop, x.device, x.dtype)


# -- residual-style MGH functions -------------------------------------------


def _rosenbrock(x):
    return _sumsq(torch.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]]))


def _freudenstein_roth(x):
    r1 = -13.0 + x[0] + ((5.0 - x[1]) * x[1] - 2.0) * x[1]
    r2 = -29.0 + x[0] + ((x[1] + 1.0) * x[1] - 14.0) * x[1]
    return r1 * r1 + r2 * r2


def _powell_badly_scaled(x):
    r1 = 1e4 * x[0] * x[1] - 1.0
    r2 = torch.exp(-x[0]) + torch.exp(-x[1]) - 1.0001
    return r1 * r1 + r2 * r2


def _brown_badly_scaled(x):
    r1 = x[0] - 1e6
    r2 = x[1] - 2e-6
    r3 = x[0] * x[1] - 2.0
    return r1 * r1 + r2 * r2 + r3 * r3


def _beale(x):
    i = _range(1, 4, x)
    r = _data("beale", x) - x[0] * (1.0 - x[1] ** i)
    return _sumsq(r)


def _jennrich_sampson(x):
    i = _range(1, 11, x)
    r = 2.0 + 2.0 * i - (torch.exp(i * x[0]) + torch.exp(i * x[1]))
    return _sumsq(r)


def _helical_valley(x):
    theta = torch.atan2(x[1], x[0]) / (2.0 * math.pi)
    r1 = 10.0 * (x[2] - 10.0 * theta)
    r2 = 10.0 * (torch.sqrt(x[0] ** 2 + x[1] ** 2) - 1.0)
    return r1 * r1 + r2 * r2 + x[2] * x[2]


def _bard(x):
    u = _range(1, 16, x)
    v = 16.0 - u
    w = torch.minimum(u, v)
    r = _data("bard", x) - (x[0] + u / (v * x[1] + w * x[2]))
    return _sumsq(r)


def _gaussian(x):
    i = _range(1, 16, x)
    t = (8.0 - i) / 2.0
    r = x[0] * torch.exp(-x[1] * (t - x[2]) ** 2 / 2.0) - _data("gaussian", x)
    return _sumsq(r)


def _meyer(x):
    i = _range(1, 17, x)
    t = 45.0 + 5.0 * i
    r = x[0] * torch.exp(x[1] / (t + x[2])) - _data("meyer", x)
    return _sumsq(r)


def _gulf(x):
    i = _range(1, 100, x)
    t = i / 100.0
    y = 25.0 + (-50.0 * torch.log(t)) ** (2.0 / 3.0)
    r = torch.exp(-torch.abs(y - x[1]) ** x[2] / x[0]) - t
    return _sumsq(r)


def _box3d(x):
    i = _range(1, 11, x)
    t = 0.1 * i
    r = (
        torch.exp(-t * x[0])
        - torch.exp(-t * x[1])
        - x[2] * (torch.exp(-t) - torch.exp(-10.0 * t))
    )
    return _sumsq(r)


def _powell_singular(x):
    r1 = x[0] + 10.0 * x[1]
    r2 = math.sqrt(5.0) * (x[2] - x[3])
    r3 = (x[1] - 2.0 * x[2]) ** 2
    r4 = math.sqrt(10.0) * (x[0] - x[3]) ** 2
    return r1 * r1 + r2 * r2 + r3 * r3 + r4 * r4


def _wood(x):
    r = torch.stack(
        [
            10.0 * (x[1] - x[0] ** 2),
            1.0 - x[0],
            math.sqrt(90.0) * (x[3] - x[2] ** 2),
            1.0 - x[2],
            math.sqrt(10.0) * (x[1] + x[3] - 2.0),
            (x[1] - x[3]) / math.sqrt(10.0),
        ]
    )
    return _sumsq(r)


def _kowalik_osborne(x):
    y = _data("kowalik_y", x)
    u = _data("kowalik_u", x)
    r = y - x[0] * (u * u + u * x[1]) / (u * u + u * x[2] + x[3])
    return _sumsq(r)


def _brown_dennis(x):
    i = _range(1, 21, x)
    t = i / 5.0
    r = (x[0] + t * x[1] - torch.exp(t)) ** 2 + (
        x[2] + x[3] * torch.sin(t) - torch.cos(t)
    ) ** 2
    return _sumsq(r)


def _biggs_exp6(x):
    i = _range(1, 14, x)
    t = 0.1 * i
    y = torch.exp(-t) - 5.0 * torch.exp(-10.0 * t) + 3.0 * torch.exp(-4.0 * t)
    r = (
        x[2] * torch.exp(-t * x[0])
        - x[3] * torch.exp(-t * x[1])
        + x[5] * torch.exp(-t * x[4])
        - y
    )
    return _sumsq(r)


def _osborne1(x):
    i = _range(0, 33, x)
    t = 10.0 * i
    r = _data("osborne1", x) - (
        x[0] + x[1] * torch.exp(-t * x[3]) + x[2] * torch.exp(-t * x[4])
    )
    return _sumsq(r)


def _osborne2(x):
    # MGH #19 (Osborne 2): 11-parameter sum of four Gaussian/exponential
    # bumps fit to 65 points; t_i = (i-1)/10.
    i = _range(0, 65, x)
    t = i / 10.0
    model = (
        x[0] * torch.exp(-t * x[4])
        + x[1] * torch.exp(-((t - x[8]) ** 2) * x[5])
        + x[2] * torch.exp(-((t - x[9]) ** 2) * x[6])
        + x[3] * torch.exp(-((t - x[10]) ** 2) * x[7])
    )
    r = _data("osborne2", x) - model
    return _sumsq(r)


@functools.lru_cache(maxsize=None)
def _watson_powers(n, device, dtype):
    """``t_i^j`` (29, n) with t_i = i / 29, and its first n - 1 columns
    times j = 1 .. n-1 (the derivative's coefficients)."""
    t = torch.arange(1, 30, dtype=dtype, device=device) / 29.0
    j = torch.arange(n, dtype=dtype, device=device)
    tj = t[:, None] ** j[None, :]
    return tj, tj[:, :-1] * torch.arange(1, n, dtype=dtype,
                                         device=device)[None, :]


def _watson(x):
    tj, dtj = _watson_powers(x.shape[0], x.device, x.dtype)
    # r_i = p'(t_i) - p(t_i)^2 - 1 with p(t) = sum_j x_j t^j.
    p = tj @ x
    dp = dtj @ x[1:]
    r = dp - p * p - 1.0
    extra1 = x[0]
    extra2 = x[1] - x[0] ** 2 - 1.0
    return _sumsq(r) + extra1 * extra1 + extra2 * extra2


def _extended_rosenbrock(x):
    even = x[0::2]
    odd = x[1::2]
    return torch.sum(100.0 * (odd - even**2) ** 2 + (1.0 - even) ** 2)


def _extended_powell(x):
    a = x[0::4]
    b = x[1::4]
    c = x[2::4]
    d = x[3::4]
    return torch.sum(
        (a + 10.0 * b) ** 2
        + 5.0 * (c - d) ** 2
        + (b - 2.0 * c) ** 4
        + 10.0 * (a - d) ** 4
    )


def _penalty1(x):
    a = 1e-5
    term1 = a * torch.sum((x - 1.0) ** 2)
    term2 = (torch.sum(x * x) - 0.25) ** 2
    return term1 + term2


def _penalty2(x):
    a = 1e-5
    n = x.shape[0]
    i = _range(2, n + 1, x)
    y = torch.exp(i / 10.0) + torch.exp((i - 1.0) / 10.0)
    r_mid = torch.exp(x[1:] / 10.0) + torch.exp(x[:-1] / 10.0) - y
    r_tail = torch.exp(x[1:] / 10.0) - math.exp(-1.0 / 10.0)
    j = _range(1, n + 1, x)
    r_last = torch.sum((n - j + 1.0) * x * x) - 1.0
    return (
        (x[0] - 0.2) ** 2
        + a * torch.sum(r_mid * r_mid)
        + a * torch.sum(r_tail * r_tail)
        + r_last * r_last
    )


def _variably_dimensioned(x):
    n = x.shape[0]
    j = _range(1, n + 1, x)
    s = torch.sum(j * (x - 1.0))
    return torch.sum((x - 1.0) ** 2) + s * s + (s * s) ** 2


def _trigonometric(x):
    n = x.shape[0]
    i = _range(1, n + 1, x)
    r = n - torch.sum(torch.cos(x)) + i * (1.0 - torch.cos(x)) - torch.sin(x)
    return _sumsq(r)


def _brown_almost_linear(x):
    n = x.shape[0]
    s = torch.sum(x)
    r_head = x + s - (n + 1.0)
    r_last = torch.prod(x) - 1.0
    return torch.sum(r_head[:-1] ** 2) + r_last * r_last


def _neighbours(x):
    """``(x_{i-1}, x_{i+1})`` with zeros past either end."""
    return F.pad(x[:-1], (1, 0)), F.pad(x[1:], (0, 1))


def _discrete_boundary(x):
    n = x.shape[0]
    h = 1.0 / (n + 1.0)
    t = _range(1, n + 1, x) * h
    xm, xp = _neighbours(x)
    r = 2.0 * x - xm - xp + h * h * (x + t + 1.0) ** 3 / 2.0
    return _sumsq(r)


def _discrete_integral(x):
    n = x.shape[0]
    h = 1.0 / (n + 1.0)
    t = _range(1, n + 1, x) * h
    cube = (x + t + 1.0) ** 3
    # r_i = x_i + h/2 [ (1-t_i) sum_{j<=i} t_j cube_j
    #                   + t_i sum_{j>i} (1-t_j) cube_j ]
    lower = torch.cumsum(t * cube, 0)
    upper_total = torch.sum((1.0 - t) * cube)
    upper = upper_total - torch.cumsum((1.0 - t) * cube, 0)
    r = x + h / 2.0 * ((1.0 - t) * lower + t * upper)
    return _sumsq(r)


def _broyden_tridiagonal(x):
    xm, xp = _neighbours(x)
    r = (3.0 - 2.0 * x) * x - xm - 2.0 * xp + 1.0
    return _sumsq(r)


@functools.lru_cache(maxsize=None)
def _banded_mask(n, device, dtype):
    """1 where j != i and max(0, i-5) <= j <= min(n-1, i+1)."""
    idx = torch.arange(n, device=device)
    mask = (idx[None, :] >= idx[:, None] - 5) & (
        idx[None, :] <= idx[:, None] + 1)
    return (mask & (idx[None, :] != idx[:, None])).to(dtype)


def _broyden_banded(x):
    mask = _banded_mask(x.shape[0], x.device, x.dtype)
    s = (mask * (x * (1.0 + x))[None, :]).sum(dim=1)
    r = x * (2.0 + 5.0 * x * x) + 1.0 - s
    return _sumsq(r)


@functools.lru_cache(maxsize=None)
def _ones(k, device, dtype):
    return torch.ones(k, dtype=dtype, device=device)


def _linear_full_rank(x, m=20):
    n = x.shape[0]
    s = torch.sum(x)
    r_head = x - 2.0 * s / m - 1.0
    tail = (-2.0 * s / m - 1.0) * _ones(m - n, x.device, x.dtype)
    return torch.sum(r_head * r_head) + torch.sum(tail * tail)


def _linear_rank1(x, m=20):
    n = x.shape[0]
    j = _range(1, n + 1, x)
    i = _range(1, m + 1, x)
    s = torch.sum(j * x)
    r = i * s - 1.0
    return _sumsq(r)


def _linear_rank1_zero(x, m=20):
    # MGH #36: linear function, rank 1 with zero columns and rows.
    # r_1 = -1, r_m = -1, r_i = (i-1) * sum_{j=2}^{n-1} j x_j - 1 otherwise.
    n = x.shape[0]
    j = _range(2, n, x)
    s = torch.sum(j * x[1:-1])
    i = _range(2, m, x)
    r_mid = (i - 1.0) * s - 1.0
    return 2.0 + _sumsq(r_mid)  # r_1^2 + r_m^2 = 2


@functools.lru_cache(maxsize=None)
def _chebyshev_integrals(n, device, dtype):
    """The integral over [0, 1] of the shifted Chebyshev polynomial T_i,
    i = 1 .. n: 0 for odd i, -1/(i^2 - 1) for even i (computed in
    ``dtype``, as the JAX package does)."""
    i = torch.arange(1, n + 1, device=device)
    even = -1.0 / (i.to(dtype) ** 2 - 1.0)
    return torch.where(i % 2 == 0, even, torch.zeros_like(even))


def _chebyquad(x):
    n = x.shape[0]
    # Chebyshev polynomials (shifted to [0, 1]) via recurrence.
    y = 2.0 * x - 1.0
    polys = [torch.ones_like(y), y]
    for _ in range(n - 1):
        polys.append(2.0 * y * polys[-1] - polys[-2])
    T = torch.stack(polys[1 : n + 1])  # (n, n) T_i at each x_j
    means = torch.mean(T, dim=1)
    r = means - _chebyshev_integrals(n, x.device, x.dtype)
    return _sumsq(r)


@functools.lru_cache(maxsize=None)
def mgh_suite(dtype_str: str = "float64") -> tuple[SuiteProblem, ...]:
    """The MGH problem set with standard starts (MGH 1981, table 1)."""
    f = np.float64 if dtype_str == "float64" else np.float32

    def arr(*vals):
        return np.asarray(vals, f)

    problems = [
        SuiteProblem("rosenbrock", _obj(_rosenbrock), arr(-1.2, 1.0), 0.0),
        SuiteProblem(
            "freudenstein_roth", _obj(_freudenstein_roth), arr(0.5, -2.0),
            48.9842,
        ),
        SuiteProblem(
            "powell_badly_scaled", _obj(_powell_badly_scaled),
            arr(0.0, 1.0), 0.0,
        ),
        SuiteProblem(
            "brown_badly_scaled", _obj(_brown_badly_scaled),
            arr(1.0, 1.0), 0.0,
        ),
        SuiteProblem("beale", _obj(_beale), arr(1.0, 1.0), 0.0),
        SuiteProblem(
            "jennrich_sampson", _obj(_jennrich_sampson), arr(0.3, 0.4),
            124.362,
        ),
        SuiteProblem(
            "helical_valley", _obj(_helical_valley), arr(-1.0, 0.0, 0.0), 0.0
        ),
        SuiteProblem("bard", _obj(_bard), arr(1.0, 1.0, 1.0), 8.21487e-3),
        SuiteProblem(
            "gaussian", _obj(_gaussian), arr(0.4, 1.0, 0.0), 1.12793e-8
        ),
        SuiteProblem(
            "meyer", _obj(_meyer), arr(0.02, 4000.0, 250.0), 87.9458
        ),
        SuiteProblem("gulf", _obj(_gulf), arr(5.0, 2.5, 0.15), 0.0),
        SuiteProblem("box3d", _obj(_box3d), arr(0.0, 10.0, 20.0), 0.0),
        SuiteProblem(
            "powell_singular", _obj(_powell_singular),
            arr(3.0, -1.0, 0.0, 1.0), 0.0,
        ),
        SuiteProblem("wood", _obj(_wood), arr(-3.0, -1.0, -3.0, -1.0), 0.0),
        SuiteProblem(
            "kowalik_osborne", _obj(_kowalik_osborne),
            arr(0.25, 0.39, 0.415, 0.39), 3.07506e-4,
        ),
        SuiteProblem(
            "brown_dennis", _obj(_brown_dennis),
            arr(25.0, 5.0, -5.0, -1.0), 85822.2,
        ),
        SuiteProblem(
            "biggs_exp6", _obj(_biggs_exp6),
            arr(1.0, 2.0, 1.0, 1.0, 1.0, 1.0), None,
        ),
        SuiteProblem(
            "osborne1", _obj(_osborne1),
            arr(0.5, 1.5, -1.0, 0.01, 0.02), 5.46489e-5,
        ),
        SuiteProblem(
            "osborne2", _obj(_osborne2),
            arr(1.3, 0.65, 0.65, 0.7, 0.6, 3.0, 5.0, 7.0, 2.0, 4.5, 5.5),
            4.01377e-2,
        ),
        SuiteProblem("watson6", _obj(_watson), np.zeros(6, f), 2.28767e-3),
        SuiteProblem(
            "extended_rosenbrock10", _obj(_extended_rosenbrock),
            np.tile(arr(-1.2, 1.0), 5), 0.0,
        ),
        SuiteProblem(
            "extended_powell12", _obj(_extended_powell),
            np.tile(arr(3.0, -1.0, 0.0, 1.0), 3), 0.0,
        ),
        SuiteProblem(
            "penalty1_10", _obj(_penalty1), np.arange(1, 11, dtype=f),
            7.08765e-5,
        ),
        SuiteProblem(
            "penalty2_10", _obj(_penalty2), np.full(10, 0.5, f), 2.93660e-4
        ),
        SuiteProblem(
            "variably_dimensioned10", _obj(_variably_dimensioned),
            1.0 - np.arange(1, 11, dtype=f) / 10.0, 0.0,
        ),
        SuiteProblem(
            "trigonometric10", _obj(_trigonometric), np.full(10, 0.1, f), 0.0
        ),
        SuiteProblem(
            "brown_almost_linear10", _obj(_brown_almost_linear),
            np.full(10, 0.5, f), None,
        ),
        SuiteProblem(
            "discrete_boundary10", _obj(_discrete_boundary),
            (np.arange(1, 11, dtype=f) / 11.0)
            * (np.arange(1, 11, dtype=f) / 11.0 - 1.0),
            0.0,
        ),
        SuiteProblem(
            "discrete_integral10", _obj(_discrete_integral),
            (np.arange(1, 11, dtype=f) / 11.0)
            * (np.arange(1, 11, dtype=f) / 11.0 - 1.0),
            0.0,
        ),
        SuiteProblem(
            "broyden_tridiagonal10", _obj(_broyden_tridiagonal),
            np.full(10, -1.0, f), 0.0,
        ),
        SuiteProblem(
            "broyden_banded10", _obj(_broyden_banded), np.full(10, -1.0, f),
            0.0,
        ),
        SuiteProblem(
            "linear_full_rank10", _obj(_linear_full_rank),
            np.ones(10, f), 10.0,
        ),
        SuiteProblem(
            "linear_rank1_10", _obj(_linear_rank1), np.ones(10, f),
            # f* = m(m-1)/(2(2m+1)) with m=20 (MGH table 2).
            20.0 * 19.0 / (2.0 * 41.0),
        ),
        SuiteProblem(
            "linear_rank1_zero10", _obj(_linear_rank1_zero), np.ones(10, f),
            # f* = (m^2 + 3m - 6)/(2(2m - 3)) with m=20.
            (400.0 + 60.0 - 6.0) / (2.0 * 37.0),
        ),
        SuiteProblem(
            "chebyquad8", _obj(_chebyquad), np.arange(1, 9, dtype=f) / 9.0,
            3.51687e-3,
        ),
    ]
    return tuple(problems)


class _BenchEntry(NamedTuple):
    problem: SuiteProblem
    #: Extra deterministic start multipliers beyond the standard x0 — the
    #: MGH paper's own protocol tests each function from x0, 10*x0, 100*x0
    #: where the function stays finite/meaningful there.
    scales: tuple


@functools.lru_cache(maxsize=None)
def _benchmark_entries(dtype_str: str = "float64") -> tuple[_BenchEntry, ...]:
    """The 376-instance benchmark's distinct-problem table.

    58 distinct analytic problems: the full 35-function MGH set at standard
    dimensions plus dimension sweeps of every variable-dimension family
    (MGH 1981 tables 1-2; the reference's external benchmark reaches 376
    problems the same way — README.md:6-11)."""
    f = np.float64 if dtype_str == "float64" else np.float32
    by_name = {p.name: p for p in mgh_suite(dtype_str)}

    def std(name, *scales):
        return _BenchEntry(by_name[name], tuple(float(s) for s in scales))

    def var(name, fn, x0, f_star, *scales):
        return _BenchEntry(
            SuiteProblem(name, _obj(fn), np.asarray(x0, f), f_star),
            tuple(float(s) for s in scales),
        )

    def rng_arange(n):
        return np.arange(1, n + 1, dtype=f)

    def disc_start(n):
        t = rng_arange(n) / (n + 1.0)
        return t * (t - 1.0)

    entries = [
        # -- fixed-dimension MGH functions (standard starts; scale
        #    multipliers only where the function is finite & sensible there).
        std("rosenbrock", 10, 100),
        std("freudenstein_roth", 10),
        std("powell_badly_scaled"),
        std("brown_badly_scaled", 10),
        std("beale", 10),
        std("jennrich_sampson"),
        std("helical_valley", 10, 100),
        std("bard", 10),
        std("gaussian"),
        std("meyer"),
        std("gulf"),
        std("box3d"),
        std("powell_singular", 10, 100),
        std("wood", 10, 100),
        std("kowalik_osborne", 10),
        std("brown_dennis", 10),
        std("biggs_exp6"),
        std("osborne1"),
        std("osborne2"),
        # -- variable-dimension families: dimension sweeps.
        var("watson6", _watson, np.zeros(6, f), 2.28767e-3),
        var("watson9", _watson, np.zeros(9, f), 1.39976e-6),
        var("watson12", _watson, np.zeros(12, f), 4.72238e-10),
    ]
    for n in (10, 20, 40):
        entries.append(var(
            f"extended_rosenbrock{n}", _extended_rosenbrock,
            np.tile(np.asarray([-1.2, 1.0], f), n // 2), 0.0, 10, 100,
        ))
    for n in (12, 24, 40):
        entries.append(var(
            f"extended_powell{n}", _extended_powell,
            np.tile(np.asarray([3.0, -1.0, 0.0, 1.0], f), n // 4), 0.0,
            10, 100,
        ))
    for n, fs in ((4, 2.24997e-5), (10, 7.08765e-5)):
        entries.append(var(f"penalty1_{n}", _penalty1, rng_arange(n), fs, 10))
    for n, fs in ((4, 9.37629e-6), (10, 2.93660e-4)):
        entries.append(var(
            f"penalty2_{n}", _penalty2, np.full(n, 0.5, f), fs, 10
        ))
    for n in (8, 10, 20):
        entries.append(var(
            f"variably_dimensioned{n}", _variably_dimensioned,
            1.0 - rng_arange(n) / n, 0.0, 10,
        ))
    for n in (5, 10, 20):
        entries.append(var(
            f"trigonometric{n}", _trigonometric, np.full(n, 1.0 / n, f),
            0.0, 10,
        ))
    for n in (10, 20, 40):
        # No scaled starts: f ~ prod(x)^2 ~ s^2n explodes double range and
        # the gradient (~1e27 at s=5, n=20) defeats any line search.  f*=0
        # is the global value (MGH table 2); the f=1 second stationary point
        # is covered by the gradient criterion.
        entries.append(var(
            f"brown_almost_linear{n}", _brown_almost_linear,
            np.full(n, 0.5, f), 0.0,
        ))
    for n in (10, 20):
        entries.append(var(
            f"discrete_boundary{n}", _discrete_boundary, disc_start(n),
            0.0, 10, 100,
        ))
        entries.append(var(
            f"discrete_integral{n}", _discrete_integral, disc_start(n),
            0.0, 10,
        ))
        entries.append(var(
            f"broyden_tridiagonal{n}", _broyden_tridiagonal,
            np.full(n, -1.0, f), 0.0, 10, 100,
        ))
        entries.append(var(
            f"broyden_banded{n}", _broyden_banded, np.full(n, -1.0, f),
            0.0, 10,
        ))
    for n, m in ((10, 20), (20, 40)):
        entries.append(var(
            f"linear_full_rank{n}_{m}",
            functools.partial(_linear_full_rank, m=m), np.ones(n, f),
            float(m - n), 10, 100,
        ))
        entries.append(var(
            f"linear_rank1_{n}_{m}",
            functools.partial(_linear_rank1, m=m), np.ones(n, f),
            m * (m - 1.0) / (2.0 * (2.0 * m + 1.0)), 10, 100,
        ))
        entries.append(var(
            f"linear_rank1_zero{n}_{m}",
            functools.partial(_linear_rank1_zero, m=m), np.ones(n, f),
            (m * m + 3.0 * m - 6.0) / (2.0 * (2.0 * m - 3.0)), 10, 100,
        ))
    for n, fs in ((7, 0.0), (8, 3.51687e-3), (10, None)):
        entries.append(var(
            f"chebyquad{n}", _chebyquad, rng_arange(n) / (n + 1.0), fs
        ))
    return tuple(entries)


def mgh_benchmark_instances(
    total: int = 376, seed: int = 0, dtype_str: str = "float64"
) -> list[tuple[SuiteProblem, np.ndarray]]:
    """Expand the benchmark entries to exactly ``total`` instances.

    Instance k of a problem starts from (in order): the standard x0; the
    MGH-style scaled starts ``s * x0`` for the entry's safe scale list; then
    deterministic seeded perturbations of x0.  With 58 distinct problems and
    total=376 each problem gets 6-7 starts, so the suite measures breadth
    across distinct analytic problems rather than jitter density."""
    entries = _benchmark_entries(dtype_str)
    base, extra = divmod(total, len(entries))
    rng = np.random.default_rng(seed)
    out = []
    for i, entry in enumerate(entries):
        k = base + (1 if i < extra else 0)
        x0 = entry.problem.x0
        starts = [x0]
        for s in entry.scales[: max(0, k - 1)]:
            starts.append(x0 * s)
        while len(starts) < k:
            jitter = rng.uniform(-0.5, 0.5, size=x0.shape)
            starts.append(x0 * (1.0 + jitter) + 0.1 * jitter)
        out.append((entry.problem, np.stack(starts).astype(x0.dtype)))
    if sum(b.shape[0] for _, b in out) != total:
        raise ValueError(
            f"total={total}: each of the {len(entries)} problems needs at "
            "least one instance")
    return out


def suite_with_multistarts(
    num_starts: int = 8, scale: float = 1.0, seed: int = 0,
    dtype_str: str = "float64",
) -> list[tuple[SuiteProblem, np.ndarray]]:
    """Expand each suite problem into `num_starts` perturbed starting points
    (the standard start plus scaled perturbations) — how the reference's
    external benchmark reaches 376 problem instances from the MGH set."""
    rng = np.random.default_rng(seed)
    out = []
    for problem in mgh_suite(dtype_str):
        starts = [problem.x0]
        for _ in range(num_starts - 1):
            jitter = rng.uniform(-0.5, 0.5, size=problem.x0.shape)
            starts.append(
                problem.x0 * (1.0 + scale * jitter) + 0.1 * scale * jitter
            )
        out.append((problem, np.stack(starts).astype(problem.x0.dtype)))
    return out
