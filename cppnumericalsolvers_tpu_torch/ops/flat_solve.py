"""Flat batched L-BFGS solve: one loop at line-search-trip granularity.

PyTorch counterpart of ``cppnumericalsolvers_tpu/ops/flat_solve.py``.  The
whole batched solve is one loop whose trip is::

    batched objective evaluation (torch.func.vmap)  ->  ONE flat_trip call

``flat_trip`` advances every lane by one line-search evaluation: the
More-Thuente trip for lanes mid-search and, for lanes whose search just
ended, the whole iteration boundary (accept/finite guard, correction pair,
the ``Progress::Update`` ladder, the curvature-gated history push, the
two-loop recursion, the descent fallback and the next search's trial 0).

Three parts:

* :func:`flat_trip_reference` -- the plain PyTorch version of one trip, a
  line-by-line counterpart of the JAX package's ``_flat_kernel`` on
  batch-major tensors.  It is what CPU tensors run, and the version the
  CUDA kernel is held against on the card.
* :func:`flat_trip` -- the wrapper of the hand-written CUDA kernel
  (``csrc/flat_trip.cu``).  CPU tensors take the plain version; CUDA
  tensors launch the kernel or raise.
* :func:`flat_lbfgs_solve` -- the loop.  It continues while any lane's
  status is CONTINUE, which costs one device-to-host read per trip; the
  number of trips is returned.

Layout is batch-major: vectors ``(B, n)``, history ``(B, m, n)`` in
chronological order (row 0 the oldest), the plateau ring ``(B, 8)`` and
all per-lane scalars packed into ``sf (B, 19)`` (float) and ``si (B, 12)``
(int32) with the row indices of the JAX kernel, so rows compare one to one.

One semantic difference from the JAX flat kernel, on purpose: ``infoc``
(``cstep``'s case code) is carried across trips of a search as MINPACK and
the JAX nested path do (``where(searching, infoc_new, infoc)``).  The JAX
flat kernel never carries it (its ``ops/flat_solve.py:556``), so a lane
whose ``cstep`` reports an input error there runs on to ``max_fev``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..core.objective import FunctionState
from ..core.progress import (
    PAST_RING_SIZE,
    ProgressState,
    StoppingCriteria,
    update_progress,
)
from ..core.status import Status
from ..linesearch.more_thuente import (
    _FTOL,
    _GTOL,
    _STPMAX,
    _STPMIN,
    _XTOL,
    cstep,
    trial_setup,
)

__all__ = [
    "FlatState",
    "init_flat_state",
    "flat_trip",
    "flat_trip_reference",
    "flat_lbfgs_solve",
]

# Packed float scalar rows (same indices as the JAX kernel).
_F_F0 = 0        # current iterate value
_F_DGINIT = 1
_F_DGTEST = 2
_F_FACC = 3      # best/accepted f during the running search
_F_STP = 4
_F_STMIN = 5
_F_STMAX = 6
_F_STX = 7
_F_FX = 8
_F_DGX = 9
_F_STY = 10
_F_FY = 11
_F_DGY = 12
_F_WIDTH = 13
_F_WIDTH1 = 14
_F_GAMMA = 15
_F_XDELTA = 16   # progress record
_F_FDELTA = 17
_F_GNORM = 18
_NF = 19

# Packed int32 scalar rows.
_I_COUNT = 0     # history count
_I_NFEV = 1      # cumulative state nfev
_I_NUMIT = 2
_I_XVIOL = 3
_I_FVIOL = 4
_I_STATUS = 5
_I_PASTPOS = 6
_I_BRACKT = 7
_I_STAGE1 = 8
_I_LSNFEV = 9
_I_INFO = 10
_I_INFOC = 11
_NI = 12

_CONT = int(Status.CONTINUE)

# Shared memory one block may use on Hopper (232,448 bytes).
_SMEM_LIMIT = 227 * 1024
_MAX_WARPS = 8
_RED_SLOTS = 8


@dataclasses.dataclass
class FlatState:
    """The loop carry; ``flat_trip`` updates it in place."""

    x0: torch.Tensor    # (B, n) current iterate
    g0: torch.Tensor    # (B, n) its gradient
    sdir: torch.Tensor  # (B, n) search direction
    gacc: torch.Tensor  # (B, n) gradient at the accepted trial
    s: torch.Tensor     # (B, m, n) history, chronological
    y: torch.Tensor     # (B, m, n)
    ring: torch.Tensor  # (B, PAST_RING_SIZE) plateau ring
    sf: torch.Tensor    # (B, _NF) float scalars
    si: torch.Tensor    # (B, _NI) int32 scalars

    def clone(self) -> "FlatState":
        return FlatState(
            **{f.name: getattr(self, f.name).clone()
               for f in dataclasses.fields(self)}
        )


def _rdot(a, b):
    return torch.sum(a * b, dim=-1)


def init_flat_state(state0: FunctionState, m: int, max_fev: int):
    """The carry at an evaluated batched start ``(B, n)`` and the first
    trial point: steepest descent with an empty history (lbfgs.h:199-213)."""
    x, g = state0.x, state0.gradient
    b, n = x.shape
    dtype, dev = x.dtype, x.device
    i32 = torch.int32
    eps = torch.finfo(dtype).eps

    gnorm = torch.sqrt(_rdot(g, g))
    one = torch.ones((b,), dtype=dtype, device=dev)
    zero = torch.zeros((b,), dtype=dtype, device=dev)
    zero_i = torch.zeros((b,), dtype=i32, device=dev)
    sdir0 = -g
    alpha0 = torch.where(gnorm > eps, 1.0 / gnorm, one)
    dginit0 = -gnorm * gnorm
    dgtest0 = _FTOL * dginit0
    no_descent = dginit0 >= 0.0
    stp_t0, stmin0, stmax0 = trial_setup(
        alpha0, zero, zero, torch.zeros((b,), dtype=torch.bool, device=dev),
        zero_i, zero_i + 1, max_fev,
    )
    stp0 = torch.where(no_descent, alpha0, stp_t0)
    info0 = torch.where(no_descent, zero_i - 1, zero_i)
    big_width = torch.full((b,), _STPMAX - _STPMIN, dtype=dtype, device=dev)

    sf = torch.zeros((b, _NF), dtype=dtype, device=dev)
    f0 = state0.value.to(dtype)
    for j, v in {
        _F_F0: f0, _F_DGINIT: dginit0, _F_DGTEST: dgtest0, _F_FACC: f0,
        _F_STP: stp0, _F_STMIN: stmin0, _F_STMAX: stmax0,
        _F_STX: zero, _F_FX: f0, _F_DGX: dginit0,
        _F_STY: zero, _F_FY: f0, _F_DGY: dginit0,
        _F_WIDTH: big_width, _F_WIDTH1: 2.0 * big_width,
        _F_GAMMA: one,
    }.items():
        sf[:, j] = v
    si = torch.zeros((b, _NI), dtype=i32, device=dev)
    si[:, _I_NFEV] = state0.nfev.to(i32)
    si[:, _I_STATUS] = _CONT
    si[:, _I_INFO] = info0
    si[:, _I_STAGE1] = 1
    si[:, _I_INFOC] = 1

    st = FlatState(
        x0=x.clone(),
        g0=g.clone(),
        sdir=sdir0,
        gacc=g.clone(),
        s=torch.zeros((b, m, n), dtype=dtype, device=dev),
        y=torch.zeros((b, m, n), dtype=dtype, device=dev),
        ring=torch.zeros((b, PAST_RING_SIZE), dtype=dtype, device=dev),
        sf=sf,
        si=si,
    )
    x_trial = x + stp0[:, None] * sdir0
    return st, x_trial


def flat_trip_reference(
    st: FlatState,
    f_t: torch.Tensor,
    g_t: torch.Tensor,
    x_trial: torch.Tensor,
    stopping: StoppingCriteria,
    max_fev: int,
) -> None:
    """One trip in plain PyTorch: updates ``st`` and writes the next trial
    point into ``x_trial``, in place.  ``f_t``/``g_t`` are the objective at
    the current ``x_trial``."""
    x0, g0, sdir = st.x0, st.g0, st.sdir
    b, m, n = st.s.shape
    dtype = x0.dtype
    eps = torch.finfo(dtype).eps
    i32 = torch.int32
    sf, si = st.sf, st.si

    def frow(j):
        return sf[:, j]

    def irow(j):
        return si[:, j]

    def ifull(v):
        return torch.full((b,), v, dtype=i32, device=x0.device)

    def col(v):
        return v[:, None]

    status = irow(_I_STATUS)
    live = status == _CONT
    info_in = irow(_I_INFO)
    active = live & (info_in == 0)  # lanes mid-search

    f0 = frow(_F_F0)
    dginit = frow(_F_DGINIT)
    dgtest = frow(_F_DGTEST)
    stp = frow(_F_STP)
    stmin = frow(_F_STMIN)
    stmax = frow(_F_STMAX)
    stx = frow(_F_STX)
    fx = frow(_F_FX)
    dgx = frow(_F_DGX)
    sty = frow(_F_STY)
    fy = frow(_F_FY)
    dgy = frow(_F_DGY)
    width = frow(_F_WIDTH)
    width1 = frow(_F_WIDTH1)
    brackt = irow(_I_BRACKT) != 0
    stage1_i = irow(_I_STAGE1)
    ls_nfev = irow(_I_LSNFEV)
    infoc = irow(_I_INFOC)

    # --- More-Thuente trip (more_thuente.h:199-252) -----------------------
    dg = _rdot(g_t, sdir)
    ftest1 = f0 + stp * dgtest
    nfev1 = ls_nfev + 1

    info_new = torch.where(
        (brackt & ((stp <= stmin) | (stp >= stmax))) | (infoc == 0),
        ifull(6), ifull(0),
    )
    info_new = torch.where(
        (stp == _STPMAX) & (f_t <= ftest1) & (dg <= dgtest), ifull(5),
        info_new,
    )
    info_new = torch.where(
        (stp == _STPMIN) & ((f_t > ftest1) | (dg >= dgtest)), ifull(4),
        info_new,
    )
    info_new = torch.where(nfev1 >= max_fev, ifull(3), info_new)
    info_new = torch.where(
        brackt & (stmax - stmin <= _XTOL * stmax), ifull(2), info_new
    )
    info_new = torch.where(
        (f_t <= ftest1) & (torch.abs(dg) <= _GTOL * (-dginit)), ifull(1),
        info_new,
    )
    searching = active & (info_new == 0)

    stage1_new_i = torch.where(
        (stage1_i != 0) & (f_t <= ftest1) & (dg >= min(_FTOL, _GTOL) * dginit),
        ifull(0), stage1_i,
    )

    use_modified = (stage1_new_i != 0) & (f_t <= fx) & (f_t > ftest1)
    fm = torch.where(use_modified, f_t - stp * dgtest, f_t)
    fxm = torch.where(use_modified, fx - stx * dgtest, fx)
    fym = torch.where(use_modified, fy - sty * dgtest, fy)
    dgm = torch.where(use_modified, dg - dgtest, dg)
    dgxm = torch.where(use_modified, dgx - dgtest, dgx)
    dgym = torch.where(use_modified, dgy - dgtest, dgy)

    cs = cstep(stx, fxm, dgxm, sty, fym, dgym, stp, fm, dgm, brackt, stmin,
               stmax)
    infoc_new = cs.info
    stx_c = cs.stx
    fx_c = torch.where(use_modified, cs.fx + cs.stx * dgtest, cs.fx)
    dgx_c = torch.where(use_modified, cs.dx + dgtest, cs.dx)
    sty_c = cs.sty
    fy_c = torch.where(use_modified, cs.fy + cs.sty * dgtest, cs.fy)
    dgy_c = torch.where(use_modified, cs.dy + dgtest, cs.dy)
    brackt_c = cs.brackt

    # Forced bisection when the bracket shrinks too slowly.
    stp_c = torch.where(
        brackt_c & (torch.abs(sty_c - stx_c) >= 0.66 * width1),
        stx_c + 0.5 * (sty_c - stx_c),
        cs.stp,
    )
    width1_c = torch.where(brackt_c, width, width1)
    width_c = torch.where(brackt_c, torch.abs(sty_c - stx_c), width)

    stp_t, stmin_t, stmax_t = trial_setup(
        stp_c, stx_c, sty_c, brackt_c, nfev1, infoc_new, max_fev
    )

    def upd(new, old):
        return torch.where(searching, new, old)

    stp1 = upd(stp_t, stp)
    stmin1 = upd(stmin_t, stmin)
    stmax1 = upd(stmax_t, stmax)
    stx1 = upd(stx_c, stx)
    fx1 = upd(fx_c, fx)
    dgx1 = upd(dgx_c, dgx)
    sty1 = upd(sty_c, sty)
    fy1 = upd(fy_c, fy)
    dgy1 = upd(dgy_c, dgy)
    width_1 = upd(width_c, width)
    width1_1 = upd(width1_c, width1)
    brackt1 = upd(brackt_c.to(i32), irow(_I_BRACKT))
    stage1_1 = upd(stage1_new_i, stage1_i)
    infoc1 = upd(infoc_new, infoc)  # the MINPACK carry (see module note)
    gacc1 = torch.where(col(active), g_t, st.gacc)
    facc1 = torch.where(active, f_t, frow(_F_FACC))
    ls_nfev1 = torch.where(active, nfev1, ls_nfev)
    info1 = torch.where(active, info_new, info_in)

    # --- Iteration boundary: lanes whose search is over -------------------
    boundary = live & (info1 != 0)

    evaled = ls_nfev1 > 0
    x_ls = torch.where(col(evaled), x0 + col(stp1) * sdir, x0)
    f_ls = torch.where(evaled, facc1, f0)
    g_ls = torch.where(col(evaled), gacc1, g0)

    finite = torch.isfinite(f_ls)
    take = finite & boundary
    x1 = torch.where(col(take), x_ls, x0)
    f1 = torch.where(take, f_ls, f0)
    g1 = torch.where(col(take), g_ls, g0)
    nfev_st = torch.where(boundary, irow(_I_NFEV) + ls_nfev1, irow(_I_NFEV))

    s_new = x1 - x0
    y_new = g1 - g0
    x_delta = torch.amax(torch.abs(s_new), dim=-1)
    count = torch.where(boundary & (x_delta <= 0.0), ifull(0),
                        irow(_I_COUNT))

    # Progress::Update ladder (progress.h:153-327), kept for boundary lanes.
    pr = update_progress(
        ProgressState(
            num_iterations=irow(_I_NUMIT),
            x_delta=frow(_F_XDELTA),
            x_delta_violations=irow(_I_XVIOL),
            f_delta=frow(_F_FDELTA),
            f_delta_violations=irow(_I_FVIOL),
            gradient_norm=frow(_F_GNORM),
            condition_hessian=torch.zeros_like(f0),
            status=status,
            past_ring=st.ring,
            past_pos=irow(_I_PASTPOS),
        ),
        FunctionState(x=x0, value=f0, gradient=g0, nfev=irow(_I_NFEV)),
        FunctionState(x=x1, value=f1, gradient=g1, nfev=nfev_st),
        stopping,
    )
    status1 = torch.where(boundary, pr.status, status)

    # --- History push + two-loop + fallback + trial 0 ---------------------
    # The push must not land for lanes that just converged.
    push_live = boundary & (status1 == _CONT)
    valid = push_live & finite

    sy = _rdot(s_new, y_new)
    s2 = _rdot(s_new, s_new)
    y2 = _rdot(y_new, y_new)
    threshold = eps * torch.sqrt(s2) * torch.sqrt(y2)
    accept = valid & (sy > threshold)
    full = count >= m
    slot = torch.clamp_max(count, m - 1)
    new_count = torch.where(accept & ~full, count + 1, count)
    gamma = frow(_F_GAMMA)
    temp = sy / torch.where(y2 > eps, y2, torch.ones_like(y2))
    gamma_ok = (
        valid & (y2 > eps) & torch.isfinite(temp) & (torch.abs(temp) <= 1e7)
    )
    new_gamma = torch.where(
        gamma_ok, torch.clamp_min(temp, eps), gamma
    )

    rows = torch.arange(m, device=x0.device)
    shift = (accept & full)[:, None] & (rows < m - 1)[None, :]
    up = torch.cat([st.s[:, 1:], st.s[:, -1:]], dim=1)
    up_y = torch.cat([st.y[:, 1:], st.y[:, -1:]], dim=1)
    write = (accept[:, None] & (slot[:, None] == rows[None, :]))[..., None]
    s_o = torch.where(write, s_new[:, None, :],
                      torch.where(shift[..., None], up, st.s))
    y_o = torch.where(write, y_new[:, None, :],
                      torch.where(shift[..., None], up_y, st.y))

    alphas, rhos, usables = [None] * m, [None] * m, [None] * m
    q = g1
    for r in range(m - 1, -1, -1):
        s_r, y_r = s_o[:, r], y_o[:, r]
        denom = _rdot(s_r, y_r)
        usable = (new_count > r) & (torch.abs(denom) >= eps)
        rho = torch.where(usable, 1.0 / denom, torch.zeros_like(denom))
        alpha = rho * _rdot(s_r, q)
        q = torch.where(col(usable), q - col(alpha) * y_r, q)
        alphas[r], rhos[r], usables[r] = alpha, rho, usable
    q = q * col(new_gamma)
    for r in range(m):
        s_r, y_r = s_o[:, r], y_o[:, r]
        beta = rhos[r] * _rdot(y_r, q)
        q = torch.where(col(usables[r]), q + s_r * col(alphas[r] - beta), q)

    one = torch.ones_like(f0)
    xnorm = torch.sqrt(_rdot(x1, x1))
    relative_eps = eps * torch.maximum(one, xnorm)
    descent = -_rdot(g1, q)
    dnorm = torch.sqrt(_rdot(q, q))
    gnorm_full = torch.sqrt(_rdot(g1, g1))

    alpha0 = torch.where(
        new_count == 0, torch.where(dnorm > eps, 1.0 / dnorm, one), one
    )
    invalid = ~torch.isfinite(descent) | (descent > -eps * relative_eps)
    dir_ = torch.where(col(invalid), g1, q)
    alpha0 = torch.where(
        invalid, torch.where(gnorm_full > eps, 1.0 / gnorm_full, one), alpha0
    )
    new_count = torch.where(invalid & push_live, ifull(0), new_count)
    ls_dir_new = -dir_
    dginit_new = _rdot(g1, ls_dir_new)
    dgtest_new = _FTOL * dginit_new

    zero = torch.zeros_like(f0)
    no_descent = dginit_new >= 0.0
    stp_t0, stmin0, stmax0 = trial_setup(
        alpha0, zero, zero, torch.zeros_like(boundary), ifull(0), ifull(1),
        max_fev,
    )
    stp0 = torch.where(no_descent, alpha0, stp_t0)
    info0 = torch.where(no_descent, ifull(-1), ifull(0))
    big_width = torch.full_like(f0, _STPMAX - _STPMIN)

    # --- Merge: boundary lanes reset their search, searching lanes keep the
    # trip results, dead lanes keep everything. ----------------------------
    def sel3(bnd_val, search_val):
        return torch.where(boundary, bnd_val, search_val)

    x0_out = torch.where(col(boundary), x1, x0)
    sdir_out = torch.where(col(boundary), ls_dir_new, sdir)
    live1 = status1 == _CONT
    next_stp = torch.where(live1, sel3(stp0, stp1), zero)
    x_trial.copy_(x0_out + col(next_stp) * sdir_out)

    sf_new = [None] * _NF
    sf_new[_F_F0] = sel3(f1, f0)
    sf_new[_F_DGINIT] = sel3(dginit_new, dginit)
    sf_new[_F_DGTEST] = sel3(dgtest_new, dgtest)
    sf_new[_F_FACC] = sel3(f1, facc1)
    sf_new[_F_STP] = sel3(stp0, stp1)
    sf_new[_F_STMIN] = sel3(stmin0, stmin1)
    sf_new[_F_STMAX] = sel3(stmax0, stmax1)
    sf_new[_F_STX] = sel3(zero, stx1)
    sf_new[_F_FX] = sel3(f1, fx1)
    sf_new[_F_DGX] = sel3(dginit_new, dgx1)
    sf_new[_F_STY] = sel3(zero, sty1)
    sf_new[_F_FY] = sel3(f1, fy1)
    sf_new[_F_DGY] = sel3(dginit_new, dgy1)
    sf_new[_F_WIDTH] = sel3(big_width, width_1)
    sf_new[_F_WIDTH1] = sel3(2.0 * big_width, width1_1)
    sf_new[_F_GAMMA] = sel3(new_gamma, gamma)
    sf_new[_F_XDELTA] = sel3(pr.x_delta, frow(_F_XDELTA))
    sf_new[_F_FDELTA] = sel3(pr.f_delta, frow(_F_FDELTA))
    sf_new[_F_GNORM] = sel3(pr.gradient_norm, frow(_F_GNORM))

    si_new = [None] * _NI
    si_new[_I_COUNT] = sel3(new_count, count)
    si_new[_I_NFEV] = nfev_st
    si_new[_I_NUMIT] = sel3(pr.num_iterations, irow(_I_NUMIT))
    si_new[_I_XVIOL] = sel3(pr.x_delta_violations, irow(_I_XVIOL))
    si_new[_I_FVIOL] = sel3(pr.f_delta_violations, irow(_I_FVIOL))
    si_new[_I_STATUS] = status1
    si_new[_I_PASTPOS] = sel3(pr.past_pos, irow(_I_PASTPOS))
    si_new[_I_BRACKT] = sel3(ifull(0), brackt1)
    si_new[_I_STAGE1] = sel3(ifull(1), stage1_1)
    si_new[_I_LSNFEV] = sel3(ifull(0), ls_nfev1)
    si_new[_I_INFO] = sel3(info0, info1)
    si_new[_I_INFOC] = sel3(ifull(1), infoc1)

    st.ring.copy_(torch.where(col(boundary), pr.past_ring, st.ring))
    st.s.copy_(s_o)
    st.y.copy_(y_o)
    st.gacc.copy_(torch.where(col(boundary), g1, gacc1))
    st.g0.copy_(torch.where(col(boundary), g1, g0))
    st.sdir.copy_(sdir_out)
    st.x0.copy_(x0_out)
    st.sf.copy_(torch.stack(sf_new, dim=1))
    st.si.copy_(torch.stack(si_new, dim=1))


def _check_trip_args(st: FlatState, f_t, g_t, x_trial):
    b, m, n = st.s.shape
    dtype = st.x0.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"flat_trip supports float32/float64, got {dtype}")
    expect = {
        "x0": (st.x0, (b, n), dtype), "g0": (st.g0, (b, n), dtype),
        "sdir": (st.sdir, (b, n), dtype), "gacc": (st.gacc, (b, n), dtype),
        "s": (st.s, (b, m, n), dtype), "y": (st.y, (b, m, n), dtype),
        "ring": (st.ring, (b, PAST_RING_SIZE), dtype),
        "sf": (st.sf, (b, _NF), dtype), "si": (st.si, (b, _NI), torch.int32),
        "f_t": (f_t, (b,), dtype), "g_t": (g_t, (b, n), dtype),
        "x_trial": (x_trial, (b, n), dtype),
    }
    for name, (t, shape, dt) in expect.items():
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(
                f"flat_trip: {name} must be {dt} of shape {shape}, got "
                f"{t.dtype} of shape {tuple(t.shape)}"
            )
        if t.device != st.x0.device:
            raise ValueError(f"flat_trip: {name} is on {t.device}, "
                             f"expected {st.x0.device}")
        if not t.is_contiguous():
            raise ValueError(f"flat_trip: {name} must be contiguous")
    return b, m, n


def flat_trip_smem_bytes(m: int, n: int, itemsize: int) -> int:
    """Dynamic shared memory of one block of the CUDA kernel: the two-loop's
    ``q`` (n values), per-row alpha/rho (m each), the usable flags and the
    block-reduction scratch."""
    return (
        (_RED_SLOTS * _MAX_WARPS + 2 * m + n) * itemsize + 4 * m
    )


def flat_trip(
    st: FlatState,
    f_t: torch.Tensor,
    g_t: torch.Tensor,
    x_trial: torch.Tensor,
    stopping: StoppingCriteria,
    max_fev: int,
) -> None:
    """One trip, in place.  CPU tensors run :func:`flat_trip_reference`;
    CUDA tensors launch the kernel of ``csrc/flat_trip.cu`` on the current
    stream, or raise.  ``flat_trip.launches`` counts kernel launches."""
    b, m, n = _check_trip_args(st, f_t, g_t, x_trial)
    dev = st.x0.device
    if b == 0:
        return
    if dev.type == "cpu":
        flat_trip_reference(st, f_t, g_t, x_trial, stopping, max_fev)
        return
    if dev.type != "cuda":
        raise ValueError(f"flat_trip: unsupported device {dev}")
    smem = flat_trip_smem_bytes(m, n, st.x0.element_size())
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"flat_trip: n={n}, m={m} needs {smem} bytes of shared memory "
            f"per block, more than the {_SMEM_LIMIT} a Hopper block has"
        )
    from . import _build

    lib = _build.load_flat_trip()
    fn = (lib.cppns_flat_trip_f32 if st.x0.dtype == torch.float32
          else lib.cppns_flat_trip_f64)
    ptr = ctypes.c_void_p
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            ptr(st.x0.data_ptr()), ptr(st.g0.data_ptr()),
            ptr(st.sdir.data_ptr()), ptr(st.gacc.data_ptr()),
            ptr(st.s.data_ptr()), ptr(st.y.data_ptr()),
            ptr(st.ring.data_ptr()), ptr(st.sf.data_ptr()),
            ptr(st.si.data_ptr()), ptr(f_t.data_ptr()),
            ptr(g_t.data_ptr()), ptr(x_trial.data_ptr()),
            b, n, m, int(max_fev),
            stopping.x_delta, stopping.f_delta, stopping.past_delta,
            stopping.gradient_norm,
            stopping.max_iterations, stopping.x_delta_violations,
            stopping.f_delta_violations, stopping.past,
            int(stopping.f_delta_relative),
            int(stopping.gradient_norm_relative),
            ptr(stream),
        )
    if err != 0:
        raise RuntimeError(
            f"flat_trip kernel launch failed: CUDA error {err} "
            f"({lib.cppns_error_string(err).decode()})"
        )
    flat_trip.launches += 1


flat_trip.launches = 0


@dataclasses.dataclass
class FlatSolveResult:
    state: FunctionState
    progress: ProgressState
    s: torch.Tensor       # (B, m, n) chronological history
    y: torch.Tensor
    count: torch.Tensor   # (B,) int32
    gamma: torch.Tensor   # (B,)
    trips: int            # loop trips = batched evaluations = host reads


def flat_lbfgs_solve(
    objective,
    state0: FunctionState,
    stopping: StoppingCriteria,
    m: int,
    max_fev: int,
    trip=flat_trip,
) -> FlatSolveResult:
    """Run the flat batched solve from the evaluated batched start
    ``state0`` (B, n).  ``trip`` is :func:`flat_trip` (the kernel on CUDA
    tensors) or :func:`flat_trip_reference` (the plain version anywhere)."""
    st, x_trial = init_flat_state(state0, m, max_fev)
    dtype = st.x0.dtype
    trips = 0
    # One device-to-host read per trip: the any-lane-continuing predicate.
    while bool((st.si[:, _I_STATUS] == _CONT).any()):
        f_t, g_t = objective.batched_value_and_grad(x_trial)
        trip(st, f_t.to(dtype).contiguous(), g_t.to(dtype).contiguous(),
             x_trial, stopping, max_fev)
        trips += 1

    state = FunctionState(
        x=st.x0, value=st.sf[:, _F_F0].clone(), gradient=st.g0,
        nfev=st.si[:, _I_NFEV].clone(),
    )
    progress = ProgressState(
        num_iterations=st.si[:, _I_NUMIT].clone(),
        x_delta=st.sf[:, _F_XDELTA].clone(),
        x_delta_violations=st.si[:, _I_XVIOL].clone(),
        f_delta=st.sf[:, _F_FDELTA].clone(),
        f_delta_violations=st.si[:, _I_FVIOL].clone(),
        gradient_norm=st.sf[:, _F_GNORM].clone(),
        condition_hessian=torch.zeros_like(st.sf[:, _F_F0]),
        status=st.si[:, _I_STATUS].clone(),
        past_ring=st.ring,
        past_pos=st.si[:, _I_PASTPOS].clone(),
    )
    return FlatSolveResult(
        state=state, progress=progress, s=st.s, y=st.y,
        count=st.si[:, _I_COUNT].clone(), gamma=st.sf[:, _F_GAMMA].clone(),
        trips=trips,
    )
