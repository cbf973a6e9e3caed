"""More-Thuente strong-Wolfe line search: the MINPACK constants, the
branch-free ``cstep`` and the pre-evaluation trial setup.

PyTorch counterpart of ``cppnumericalsolvers_tpu/linesearch/more_thuente.py``
(``cstep``, :56-233) and of ``ops/fused_linesearch.py::_trial_setup``
(:68-97), the reference's more_thuente.h:137-407.  Every function works
elementwise on tensors of one shape (one entry per lane), computes all four
interpolation cases and selects with ``torch.where``, exactly in the JAX
package's operation order, so the float64 results agree bit for bit.

The single-instance ``more_thuente`` loop is not ported yet (ROADMAP.md,
queue A, slice 2).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["CstepState", "cstep", "trial_setup", "DEFAULT_MAX_FEV"]

# MINPACK constants (more_thuente.h:142-148).
_XTOL = 1e-15
_FTOL = 1e-4
_GTOL = 0.9
_STPMIN = 1e-15
_STPMAX = 1e15
_XTRAPF = 4.0
DEFAULT_MAX_FEV = 20


@dataclasses.dataclass
class CstepState:
    """The nine-scalar bracketing state threaded through ``cstep``."""

    stx: torch.Tensor
    fx: torch.Tensor
    dx: torch.Tensor
    sty: torch.Tensor
    fy: torch.Tensor
    dy: torch.Tensor
    stp: torch.Tensor
    brackt: torch.Tensor  # bool
    info: torch.Tensor  # int32: 0 = input error, 1..4 = interpolation case


def _sign(x):
    # jnp.sign: 0 at 0 and NaN at NaN (torch.sign gives 0 for NaN).
    one = torch.ones_like(x)
    return torch.where(x > 0, one, torch.where(x < 0, -one, x))


def _max_abs3(x, y, z):
    return torch.maximum(
        torch.abs(x), torch.maximum(torch.abs(y), torch.abs(z))
    )


def _i32(cond, value):
    return torch.where(
        cond, torch.full_like(cond, value, dtype=torch.int32),
        torch.zeros_like(cond, dtype=torch.int32),
    )


def cstep(
    stx, fx, dx, sty, fy, dy, stp, fp, dp, brackt, stpmin, stpmax
) -> CstepState:
    """Safeguarded cubic/quadratic trial-step interpolation (MINPACK
    ``cstep``, more_thuente.h:261-407).  ``info == 0`` flags the input-error
    early return; the state then comes back untouched."""
    brackt = brackt.bool()
    zero = torch.zeros_like(stx)

    input_error = (
        brackt
        & ((stp <= torch.minimum(stx, sty)) | (stp >= torch.maximum(stx, sty)))
    ) | ((dx * (stp - stx) >= 0.0) | (stpmax < stpmin))

    sgnd = dp * _sign(dx)

    d_stp_stx = stp - stx
    theta = 3.0 * (fx - fp) / d_stp_stx + dx + dp
    s = _max_abs3(theta, dx, dp)
    gamma_sq = (theta / s) * (theta / s) - (dx / s) * (dp / s)
    gamma_raw = s * torch.sqrt(gamma_sq)
    gamma3 = s * torch.sqrt(torch.maximum(zero, gamma_sq))

    # Case 1 (fp > fx): higher value, minimum bracketed.
    g1 = torch.where(stp < stx, -gamma_raw, gamma_raw)
    p1 = (g1 - dx) + theta
    q1 = ((g1 - dx) + g1) + dp
    r1 = p1 / q1
    stpc1 = stx + r1 * d_stp_stx
    stpq1 = stx + ((dx / ((fx - fp) / d_stp_stx + dx)) / 2.0) * d_stp_stx
    stpf1 = torch.where(
        torch.abs(stpc1 - stx) < torch.abs(stpq1 - stx),
        stpc1,
        stpc1 + (stpq1 - stpc1) / 2.0,
    )

    # Case 2 (sgnd < 0): derivatives of opposite sign.
    g2 = torch.where(stp > stx, -gamma_raw, gamma_raw)
    p2 = (g2 - dp) + theta
    q2 = ((g2 - dp) + g2) + dx
    r2 = p2 / q2
    stpc2 = stp + r2 * (stx - stp)
    stpq2 = stp + (dp / (dp - dx)) * (stx - stp)
    stpf2 = torch.where(
        torch.abs(stpc2 - stp) > torch.abs(stpq2 - stp), stpc2, stpq2
    )

    # Case 3 (|dp| < |dx|): derivative decreases in magnitude.
    g3 = torch.where(stp > stx, -gamma3, gamma3)
    p3 = (g3 - dp) + theta
    q3 = (g3 + (dx - dp)) + g3
    r3 = p3 / q3
    stpc3_interior = stp + r3 * (stx - stp)
    stpc3 = torch.where(
        (r3 < 0.0) & (g3 != 0.0),
        stpc3_interior,
        torch.where(stp > stx, stpmax, stpmin),
    )
    stpq3 = stp + (dp / (dp - dx)) * (stx - stp)
    stpf3 = torch.where(
        brackt,
        torch.where(
            torch.abs(stp - stpc3) < torch.abs(stp - stpq3), stpc3, stpq3
        ),
        torch.where(
            torch.abs(stp - stpc3) > torch.abs(stp - stpq3), stpc3, stpq3
        ),
    )

    # Case 4: derivative does not decrease.
    d_sty_stp = sty - stp
    theta4 = 3.0 * (fp - fy) / d_sty_stp + dy + dp
    s4 = _max_abs3(theta4, dy, dp)
    gamma4_raw = s4 * torch.sqrt(
        (theta4 / s4) * (theta4 / s4) - (dy / s4) * (dp / s4)
    )
    g4 = torch.where(stp > sty, -gamma4_raw, gamma4_raw)
    p4 = (g4 - dp) + theta4
    q4 = ((g4 - dp) + g4) + dy
    r4 = p4 / q4
    stpc4 = stp + r4 * d_sty_stp
    stpf4 = torch.where(
        brackt, stpc4, torch.where(stp > stx, stpmax, stpmin)
    )

    # Case selection, in the C++ order.
    case1 = fp > fx
    neg = sgnd < 0.0
    case2 = ~case1 & neg
    smaller = torch.abs(dp) < torch.abs(dx)
    case3 = ~case1 & ~neg & smaller
    case4 = ~case1 & ~neg & ~smaller
    info = _i32(case1, 1) + _i32(case2, 2) + _i32(case3, 3) + _i32(case4, 4)
    bound = case1 | case3
    stpf = torch.where(
        case1, stpf1, torch.where(case2, stpf2, torch.where(case3, stpf3, stpf4))
    )
    new_brackt = brackt | case1 | case2

    # Interval update (more_thuente.h:377-391).
    from_p = fp > fx
    from_x = ~from_p & neg
    new_sty = torch.where(from_p, stp, torch.where(from_x, stx, sty))
    new_fy = torch.where(from_p, fp, torch.where(from_x, fx, fy))
    new_dy = torch.where(from_p, dp, torch.where(from_x, dx, dy))
    new_stx = torch.where(from_p, stx, stp)
    new_fx = torch.where(from_p, fx, fp)
    new_dx = torch.where(from_p, dx, dp)

    # Clamp and the 0.66 safeguard (more_thuente.h:393-404).
    new_stp = torch.minimum(torch.maximum(stpf, stpmin), stpmax)
    guard = new_stx + 0.66 * (new_sty - new_stx)
    new_stp = torch.where(
        new_brackt & bound,
        torch.where(
            new_sty > new_stx,
            torch.minimum(guard, new_stp),
            torch.maximum(guard, new_stp),
        ),
        new_stp,
    )

    def keep(new, old):
        return torch.where(input_error, old, new)

    return CstepState(
        stx=keep(new_stx, stx),
        fx=keep(new_fx, fx),
        dx=keep(new_dx, dx),
        sty=keep(new_sty, sty),
        fy=keep(new_fy, fy),
        dy=keep(new_dy, dy),
        stp=keep(new_stp, stp),
        brackt=keep(new_brackt, brackt),
        info=torch.where(input_error, torch.zeros_like(info), info),
    )


def trial_setup(stp, stx, sty, brackt, nfev, infoc, max_fev: int):
    """Pre-evaluation trial-step formation (more_thuente.h:178-195): the
    interval bounds for the next trial, the clamped step and the
    unreliable-trial fallback to the best step so far.  Returns
    ``(stp_trial, stmin, stmax)``."""
    stmin = torch.where(brackt, torch.minimum(stx, sty), stx)
    stmax = torch.where(
        brackt, torch.maximum(stx, sty), stp + _XTRAPF * (stp - stx)
    )
    stp_c = torch.clamp_max(torch.clamp_min(stp, _STPMIN), _STPMAX)
    fallback = (
        (brackt & ((stp_c <= stmin) | (stp_c >= stmax)))
        | (nfev >= max_fev - 1)
        | (infoc == 0)
        | (brackt & ((stmax - stmin) <= _XTOL * stmax))
    )
    return torch.where(fallback, stx, stp_c), stmin, stmax
