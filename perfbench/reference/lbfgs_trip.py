"""The flat batched L-BFGS trip in plain PyTorch, frozen for the benchmark.

A standalone copy of the arithmetic the solver under test states for one
trip of its flat loop (a batched evaluation, then one More-Thuente trip for
lanes mid-search or, for lanes whose search just ended, the whole iteration
boundary: accept, correction pair, the stopping ladder, the curvature-gated
history push, the two-loop recursion, the descent fallback and the next
search's first trial).  It follows the MINPACK line search of More and
Thuente (ACM TOMS 20(3), 1994) and L-BFGS of Nocedal and Wright (2006, alg.
7.4), in the order cppoptlib's lbfgs.h / more_thuente.h / progress.h give.

It imports nothing of the program: later changes to the program cannot move
it.  The history is kept in chronological order (row 0 the oldest) and
shifted on a push, where the program keeps a ring; the arithmetic is the
same.  Dots are plain ``torch.sum`` over the last axis.  Inside
:func:`over_ranks` each process holds its own coordinates of every lane,
and each sum and largest magnitude over n is the local one followed by one
``all_reduce`` over the ranks.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

# MINPACK constants (more_thuente.h:142-148).
XTOL = 1e-15
FTOL = 1e-4
GTOL = 0.9
STPMIN = 1e-15
STPMAX = 1e15
XTRAPF = 4.0
PAST_RING = 8

CONTINUE, ITERATION_LIMIT, X_DELTA, F_DELTA, GRADIENT_NORM = 0, 1, 2, 3, 4


@dataclasses.dataclass(frozen=True)
class Stopping:
    """The default float32 stopping preset of cppoptlib (progress.h:353-431,
    float32 thresholds loosened as the solver under test states)."""

    max_iterations: int = 10000
    x_delta: float = 1e-7
    x_delta_violations: int = 1
    f_delta: float = 0.0
    f_delta_violations: int = 1
    gradient_norm: float = 1e-4
    past: int = 3
    past_delta: float = 1e-5


#: The process group over which the n axis is split, inside
#: :func:`over_ranks`; None where each process holds whole lanes.
_GROUP = None


@contextlib.contextmanager
def over_ranks(group):
    """Within this context the n axis of every vector is split over the
    ranks of ``group``, each holding its own contiguous coordinates."""
    global _GROUP
    outer, _GROUP = _GROUP, group
    try:
        yield
    finally:
        _GROUP = outer


def _over_ranks(s, op):
    if _GROUP is not None:
        dist.all_reduce(s, op=op, group=_GROUP)
    return s


def rank_sum(s):
    """``s``, each rank's partial sum over its coordinates, summed over the
    ranks (in place); ``s`` itself outside :func:`over_ranks`."""
    return _over_ranks(s, dist.ReduceOp.SUM)


def _dot(a, b):
    return rank_sum(torch.sum(a * b, dim=-1))


def amax_abs(a):
    """Largest magnitude over the last axis, over every rank's
    coordinates."""
    return _over_ranks(torch.amax(torch.abs(a), dim=-1), dist.ReduceOp.MAX)


def _sign(x):
    one = torch.ones_like(x)
    return torch.where(x > 0, one, torch.where(x < 0, -one, x))


def _cstep(stx, fx, dx, sty, fy, dy, stp, fp, dp, brackt, stpmin, stpmax):
    """Safeguarded cubic/quadratic step (MINPACK ``cstep``); ``info`` 0 is
    the input-error return, which leaves the state as it was."""
    zero = torch.zeros_like(stx)
    input_error = (
        brackt & ((stp <= torch.minimum(stx, sty))
                  | (stp >= torch.maximum(stx, sty)))
    ) | ((dx * (stp - stx) >= 0.0) | (stpmax < stpmin))
    sgnd = dp * _sign(dx)

    def max_abs3(a, b, c):
        return torch.maximum(torch.abs(a),
                             torch.maximum(torch.abs(b), torch.abs(c)))

    d_stp_stx = stp - stx
    theta = 3.0 * (fx - fp) / d_stp_stx + dx + dp
    s = max_abs3(theta, dx, dp)
    gamma_sq = (theta / s) * (theta / s) - (dx / s) * (dp / s)
    gamma_raw = s * torch.sqrt(gamma_sq)
    gamma3 = s * torch.sqrt(torch.maximum(zero, gamma_sq))

    g1 = torch.where(stp < stx, -gamma_raw, gamma_raw)
    p1 = (g1 - dx) + theta
    q1 = ((g1 - dx) + g1) + dp
    stpc1 = stx + (p1 / q1) * d_stp_stx
    stpq1 = stx + ((dx / ((fx - fp) / d_stp_stx + dx)) / 2.0) * d_stp_stx
    stpf1 = torch.where(torch.abs(stpc1 - stx) < torch.abs(stpq1 - stx),
                        stpc1, stpc1 + (stpq1 - stpc1) / 2.0)

    g2 = torch.where(stp > stx, -gamma_raw, gamma_raw)
    p2 = (g2 - dp) + theta
    q2 = ((g2 - dp) + g2) + dx
    stpc2 = stp + (p2 / q2) * (stx - stp)
    stpq2 = stp + (dp / (dp - dx)) * (stx - stp)
    stpf2 = torch.where(torch.abs(stpc2 - stp) > torch.abs(stpq2 - stp),
                        stpc2, stpq2)

    g3 = torch.where(stp > stx, -gamma3, gamma3)
    p3 = (g3 - dp) + theta
    q3 = (g3 + (dx - dp)) + g3
    r3 = p3 / q3
    stpc3 = torch.where((r3 < 0.0) & (g3 != 0.0), stp + r3 * (stx - stp),
                        torch.where(stp > stx, stpmax, stpmin))
    stpq3 = stp + (dp / (dp - dx)) * (stx - stp)
    stpf3 = torch.where(
        brackt,
        torch.where(torch.abs(stp - stpc3) < torch.abs(stp - stpq3),
                    stpc3, stpq3),
        torch.where(torch.abs(stp - stpc3) > torch.abs(stp - stpq3),
                    stpc3, stpq3))

    d_sty_stp = sty - stp
    theta4 = 3.0 * (fp - fy) / d_sty_stp + dy + dp
    s4 = max_abs3(theta4, dy, dp)
    gamma4 = s4 * torch.sqrt((theta4 / s4) * (theta4 / s4)
                             - (dy / s4) * (dp / s4))
    g4 = torch.where(stp > sty, -gamma4, gamma4)
    p4 = (g4 - dp) + theta4
    q4 = ((g4 - dp) + g4) + dy
    stpc4 = stp + (p4 / q4) * d_sty_stp
    stpf4 = torch.where(brackt, stpc4,
                        torch.where(stp > stx, stpmax, stpmin))

    case1 = fp > fx
    neg = sgnd < 0.0
    case2 = ~case1 & neg
    smaller = torch.abs(dp) < torch.abs(dx)
    case3 = ~case1 & ~neg & smaller
    info = torch.where(case1, 1, torch.where(case2, 2, torch.where(
        case3, 3, 4))).to(torch.int32)
    bound = case1 | case3
    stpf = torch.where(case1, stpf1, torch.where(
        case2, stpf2, torch.where(case3, stpf3, stpf4)))
    new_brackt = brackt | case1 | case2

    from_x = ~case1 & neg
    new_sty = torch.where(case1, stp, torch.where(from_x, stx, sty))
    new_fy = torch.where(case1, fp, torch.where(from_x, fx, fy))
    new_dy = torch.where(case1, dp, torch.where(from_x, dx, dy))
    new_stx = torch.where(case1, stx, stp)
    new_fx = torch.where(case1, fx, fp)
    new_dx = torch.where(case1, dx, dp)

    new_stp = torch.minimum(torch.maximum(stpf, stpmin), stpmax)
    guard = new_stx + 0.66 * (new_sty - new_stx)
    new_stp = torch.where(
        new_brackt & bound,
        torch.where(new_sty > new_stx, torch.minimum(guard, new_stp),
                    torch.maximum(guard, new_stp)),
        new_stp)

    def keep(new, old):
        return torch.where(input_error, old, new)

    return (keep(new_stx, stx), keep(new_fx, fx), keep(new_dx, dx),
            keep(new_sty, sty), keep(new_fy, fy), keep(new_dy, dy),
            keep(new_stp, stp), keep(new_brackt, brackt),
            torch.where(input_error, torch.zeros_like(info), info))


def _trial_setup(stp, stx, sty, brackt, nfev, infoc, max_fev):
    """The next trial's interval and clamped step, with the fallback to the
    best step so far (more_thuente.h:178-195)."""
    stmin = torch.where(brackt, torch.minimum(stx, sty), stx)
    stmax = torch.where(brackt, torch.maximum(stx, sty),
                        stp + XTRAPF * (stp - stx))
    stp_c = torch.clamp(stp, STPMIN, STPMAX)
    fallback = ((brackt & ((stp_c <= stmin) | (stp_c >= stmax)))
                | (nfev >= max_fev - 1) | (infoc == 0)
                | (brackt & ((stmax - stmin) <= XTOL * stmax)))
    return torch.where(fallback, stx, stp_c), stmin, stmax


@dataclasses.dataclass
class State:
    """One lane per row: the iterate, its gradient, the search and the
    stopping record.  Vectors ``(B, n)``, history ``(B, m, n)``
    chronological, scalars ``(B,)``."""

    x0: torch.Tensor
    f0: torch.Tensor
    g0: torch.Tensor
    sdir: torch.Tensor
    xacc: torch.Tensor
    gacc: torch.Tensor
    facc: torch.Tensor
    s: torch.Tensor
    y: torch.Tensor
    count: torch.Tensor
    gamma: torch.Tensor
    dginit: torch.Tensor
    dgtest: torch.Tensor
    stp: torch.Tensor
    stmin: torch.Tensor
    stmax: torch.Tensor
    stx: torch.Tensor
    fx: torch.Tensor
    dgx: torch.Tensor
    sty: torch.Tensor
    fy: torch.Tensor
    dgy: torch.Tensor
    width: torch.Tensor
    width1: torch.Tensor
    brackt: torch.Tensor
    stage1: torch.Tensor
    ls_nfev: torch.Tensor
    info: torch.Tensor
    infoc: torch.Tensor
    nfev: torch.Tensor
    status: torch.Tensor
    numit: torch.Tensor
    xviol: torch.Tensor
    fviol: torch.Tensor
    ring: torch.Tensor
    past_pos: torch.Tensor


def _search_start(alpha, dginit, max_fev):
    """The first trial of a search along a direction with slope
    ``dginit``: ``(stp, stmin, stmax, info)``, ``info`` -1 where the
    direction does not descend."""
    zero = torch.zeros_like(alpha)
    izero = torch.zeros_like(alpha, dtype=torch.int32)
    stp_t, stmin, stmax = _trial_setup(
        alpha, zero, zero, torch.zeros_like(alpha, dtype=torch.bool), izero,
        izero + 1, max_fev)
    no_descent = dginit >= 0.0
    return (torch.where(no_descent, alpha, stp_t), stmin, stmax,
            torch.where(no_descent, -1, 0).to(torch.int32))


def init_state(x, f, g, m, max_fev):
    """The carry at an evaluated start and its first trial point: steepest
    descent with an empty history (lbfgs.h:199-213)."""
    b, n = x.shape
    eps = torch.finfo(x.dtype).eps
    gnorm = torch.sqrt(_dot(g, g))
    one = torch.ones_like(f)
    zero = torch.zeros_like(f)
    izero = torch.zeros_like(f, dtype=torch.int32)
    alpha = torch.where(gnorm > eps, 1.0 / gnorm, one)
    dginit = -gnorm * gnorm
    stp, stmin, stmax, info = _search_start(alpha, dginit, max_fev)
    big = torch.full_like(f, STPMAX - STPMIN)
    st = State(
        x0=x.clone(), f0=f.clone(), g0=g.clone(), sdir=-g, xacc=x.clone(),
        gacc=g.clone(),
        facc=f.clone(),
        s=x.new_zeros((b, m, n)), y=x.new_zeros((b, m, n)),
        count=izero.clone(), gamma=one.clone(), dginit=dginit,
        dgtest=FTOL * dginit, stp=stp, stmin=stmin, stmax=stmax,
        stx=zero.clone(), fx=f.clone(), dgx=dginit.clone(), sty=zero.clone(),
        fy=f.clone(), dgy=dginit.clone(), width=big, width1=2.0 * big,
        brackt=izero.clone(), stage1=izero + 1, ls_nfev=izero.clone(),
        info=info, infoc=izero + 1, nfev=izero + 1,
        status=izero.clone(), numit=izero.clone(), xviol=izero.clone(),
        fviol=izero.clone(), ring=x.new_zeros((b, PAST_RING)),
        past_pos=izero.clone(),
    )
    return st, x + stp[:, None] * st.sdir


def _mt_trip(st, f_t, dg, max_fev):
    """The scalar half of a post-evaluation More-Thuente trip
    (more_thuente.h:199-252); returns the decision ``info`` and the
    bracketing state a lane that searches on moves to."""
    brackt = st.brackt != 0
    stp, dginit, dgtest = st.stp, st.dginit, st.dgtest
    nfev1 = st.ls_nfev + 1
    ftest1 = st.f0 + stp * dgtest
    info = torch.where(
        (brackt & ((stp <= st.stmin) | (stp >= st.stmax))) | (st.infoc == 0),
        6, 0)
    info = torch.where((stp == STPMAX) & (f_t <= ftest1) & (dg <= dgtest),
                       5, info)
    info = torch.where((stp == STPMIN) & ((f_t > ftest1) | (dg >= dgtest)),
                       4, info)
    info = torch.where(nfev1 >= max_fev, 3, info)
    info = torch.where(brackt & (st.stmax - st.stmin <= XTOL * st.stmax), 2,
                       info)
    info = torch.where((f_t <= ftest1) & (torch.abs(dg) <= GTOL * (-dginit)),
                       1, info).to(torch.int32)
    stage1 = torch.where(
        (st.stage1 != 0) & (f_t <= ftest1) & (dg >= min(FTOL, GTOL) * dginit),
        0, st.stage1).to(torch.int32)

    mod = (stage1 != 0) & (f_t <= st.fx) & (f_t > ftest1)
    fm = torch.where(mod, f_t - stp * dgtest, f_t)
    fxm = torch.where(mod, st.fx - st.stx * dgtest, st.fx)
    fym = torch.where(mod, st.fy - st.sty * dgtest, st.fy)
    dgm = torch.where(mod, dg - dgtest, dg)
    dgxm = torch.where(mod, st.dgx - dgtest, st.dgx)
    dgym = torch.where(mod, st.dgy - dgtest, st.dgy)
    stx, fx, dx, sty, fy, dy, stpc, brk, infoc = _cstep(
        st.stx, fxm, dgxm, st.sty, fym, dgym, stp, fm, dgm, brackt,
        st.stmin, st.stmax)
    fx = torch.where(mod, fx + stx * dgtest, fx)
    dx = torch.where(mod, dx + dgtest, dx)
    fy = torch.where(mod, fy + sty * dgtest, fy)
    dy = torch.where(mod, dy + dgtest, dy)
    stpc = torch.where(brk & (torch.abs(sty - stx) >= 0.66 * st.width1),
                       stx + 0.5 * (sty - stx), stpc)
    width1 = torch.where(brk, st.width, st.width1)
    width = torch.where(brk, torch.abs(sty - stx), st.width)
    stp_t, stmin, stmax = _trial_setup(stpc, stx, sty, brk, nfev1, infoc,
                                       max_fev)
    return info, dict(stp=stp_t, stmin=stmin, stmax=stmax, stx=stx, fx=fx,
                      dgx=dx, sty=sty, fy=fy, dgy=dy, width=width,
                      width1=width1, brackt=brk.to(torch.int32),
                      stage1=stage1, infoc=infoc), nfev1


def _progress(st, x1, f1, g1, boundary, crit):
    """The stopping ladder (progress.h:153-327) for lanes at a boundary:
    ``(status, numit, xviol, fviol, ring, past_pos)``."""
    one = torch.ones_like(f1)
    numit = st.numit + 1
    f_delta = torch.abs(f1 - st.f0)
    x_delta = amax_abs(x1 - st.x0)
    gnorm = amax_abs(g1)
    status = torch.zeros_like(st.status)

    def first(status, cond, code):
        return torch.where((status == CONTINUE) & cond, code, status)

    status = first(status, (crit.max_iterations > 0)
                   & (numit > crit.max_iterations), ITERATION_LIMIT)
    reached = status == CONTINUE
    x_cond = (crit.x_delta > 0) & (x_delta < crit.x_delta)
    xviol = torch.where(reached, torch.where(x_cond, st.xviol + 1, 0),
                        st.xviol).to(torch.int32)
    status = first(status, x_cond & (xviol >= crit.x_delta_violations),
                   X_DELTA)
    reached = status == CONTINUE
    f_cond = (crit.f_delta > 0) & (f_delta < crit.f_delta)
    fviol = torch.where(reached, torch.where(f_cond, st.fviol + 1, 0),
                        st.fviol).to(torch.int32)
    status = first(status, f_cond & (fviol >= crit.f_delta_violations),
                   F_DELTA)
    reached = status == CONTINUE
    ring = st.ring
    if crit.past > 0:
        ring = torch.where((numit == 1)[:, None], f1[:, None], ring)
    at_pos = (torch.arange(PAST_RING, device=f1.device)
              == st.past_pos[:, None].long())
    past_f = torch.sum(torch.where(at_pos, ring, torch.zeros_like(ring)), -1)
    rate = torch.abs(past_f - f1) / torch.maximum(one, torch.abs(f1))
    plateau = (crit.past > 0) & (numit > crit.past) & (rate < crit.past_delta)
    status = first(status, plateau, F_DELTA)
    write = (status == CONTINUE) & reached & (crit.past > 0)
    ring = torch.where(at_pos & write[:, None], f1[:, None], ring)
    past_pos = torch.where(
        write, torch.where(st.past_pos + 1 >= crit.past, 0, st.past_pos + 1),
        st.past_pos).to(torch.int32)
    scale = torch.maximum(one, amax_abs(x1))
    status = first(status, (crit.gradient_norm > 0)
                   & (gnorm < crit.gradient_norm * scale), GRADIENT_NORM)

    def keep(new, old):
        return torch.where(boundary, new, old)

    return (keep(status, st.status), keep(numit, st.numit).to(torch.int32),
            keep(xviol, st.xviol), keep(fviol, st.fviol),
            torch.where(boundary[:, None], ring, st.ring),
            keep(past_pos, st.past_pos))


def _two_loop(g, s, y, count, gamma):
    """``H g`` over the rows below ``count`` (lbfgs.h:141-196), skipping a
    row whose ``|s.y| < eps``."""
    m = s.shape[1]
    eps = torch.finfo(g.dtype).eps
    alphas, rhos, usable = [None] * m, [None] * m, [None] * m
    q = g
    for r in range(m - 1, -1, -1):
        denom = _dot(s[:, r], y[:, r])
        usable[r] = (count > r) & (torch.abs(denom) >= eps)
        rhos[r] = torch.where(usable[r], 1.0 / denom, torch.zeros_like(denom))
        alphas[r] = rhos[r] * _dot(s[:, r], q)
        q = torch.where(usable[r][:, None], q - alphas[r][:, None] * y[:, r],
                        q)
    q = q * gamma[:, None]
    for r in range(m):
        beta = rhos[r] * _dot(y[:, r], q)
        q = torch.where(usable[r][:, None],
                        q + s[:, r] * (alphas[r] - beta)[:, None], q)
    return q


def trip(st, f_t, g_t, x_trial, crit, max_fev):
    """One trip: updates ``st`` and returns the next trial point."""
    eps = torch.finfo(f_t.dtype).eps
    live = st.status == CONTINUE
    active = live & (st.info == 0)
    col = (lambda v: v[:, None])

    info_new, mt, nfev1 = _mt_trip(st, f_t, _dot(g_t, st.sdir), max_fev)
    searching = active & (info_new == 0)
    for k, v in mt.items():
        setattr(st, k, torch.where(searching, v, getattr(st, k)))
    st.xacc = torch.where(col(active), x_trial, st.xacc)
    st.gacc = torch.where(col(active), g_t, st.gacc)
    st.facc = torch.where(active, f_t, st.facc)
    st.ls_nfev = torch.where(active, nfev1, st.ls_nfev)
    st.info = torch.where(active, info_new, st.info)

    boundary = live & (st.info != 0)
    evaled = st.ls_nfev > 0
    x_ls = torch.where(col(evaled), st.xacc, st.x0)
    f_ls = torch.where(evaled, st.facc, st.f0)
    g_ls = torch.where(col(evaled), st.gacc, st.g0)
    finite = torch.isfinite(f_ls)
    take = finite & boundary
    x1 = torch.where(col(take), x_ls, st.x0)
    f1 = torch.where(take, f_ls, st.f0)
    g1 = torch.where(col(take), g_ls, st.g0)
    st.nfev = torch.where(boundary, st.nfev + st.ls_nfev, st.nfev)
    s_new, y_new = x1 - st.x0, g1 - st.g0
    count = torch.where(
        boundary & (amax_abs(s_new) <= 0.0), 0,
        st.count).to(torch.int32)
    (status, st.numit, st.xviol, st.fviol, st.ring,
     st.past_pos) = _progress(st, x1, f1, g1, boundary, crit)

    # Curvature-gated push (lbfgs.h:253-298): a full history drops its
    # oldest row.
    m = st.s.shape[1]
    push = boundary & (status == CONTINUE)
    sy, s2, y2 = _dot(s_new, y_new), _dot(s_new, s_new), _dot(y_new, y_new)
    accept = push & finite & (sy > eps * torch.sqrt(s2) * torch.sqrt(y2))
    full = count >= m
    new_count = torch.where(accept & ~full, count + 1, count)
    temp = sy / torch.where(y2 > eps, y2, torch.ones_like(y2))
    gamma_ok = (push & finite & (y2 > eps) & torch.isfinite(temp)
                & (torch.abs(temp) <= 1e7))
    new_gamma = torch.where(gamma_ok, torch.clamp_min(temp, eps), st.gamma)
    rows = torch.arange(m, device=f_t.device)
    slot = torch.clamp_max(count, m - 1)
    shift = ((accept & full)[:, None] & (rows < m - 1)[None, :])[..., None]
    write = (accept[:, None] & (slot[:, None] == rows[None, :]))[..., None]

    def pushed(buf, row):
        up = torch.cat([buf[:, 1:], buf[:, -1:]], dim=1)
        return torch.where(write, row[:, None, :],
                           torch.where(shift, up, buf))

    s_o, y_o = pushed(st.s, s_new), pushed(st.y, y_new)
    d = _two_loop(g1, s_o, y_o, new_count, new_gamma)

    # Descent check and the steepest-descent fallback (lbfgs.h:199-224).
    one = torch.ones_like(f1)
    rel = eps * torch.maximum(one, torch.sqrt(_dot(x1, x1)))
    descent = -_dot(g1, d)
    dnorm, gnorm = torch.sqrt(_dot(d, d)), torch.sqrt(_dot(g1, g1))
    alpha = torch.where(new_count == 0,
                        torch.where(dnorm > eps, 1.0 / dnorm, one), one)
    invalid = ~torch.isfinite(descent) | (descent > -eps * rel)
    alpha = torch.where(invalid, torch.where(gnorm > eps, 1.0 / gnorm, one),
                        alpha)
    ls_dir = -torch.where(col(invalid), g1, d)
    dginit = _dot(g1, ls_dir)
    new_count = torch.where(invalid & push, 0, new_count).to(torch.int32)
    stp0, stmin0, stmax0, info0 = _search_start(alpha, dginit, max_fev)
    big = torch.full_like(f1, STPMAX - STPMIN)

    def sel(bnd, old):
        return torch.where(boundary, bnd, old)

    st.stp = sel(stp0, st.stp)
    st.stmin = sel(stmin0, st.stmin)
    st.stmax = sel(stmax0, st.stmax)
    for k in ("stx", "sty"):
        setattr(st, k, sel(torch.zeros_like(f1), getattr(st, k)))
    st.fx, st.fy = sel(f1, st.fx), sel(f1, st.fy)
    st.dgx, st.dgy = sel(dginit, st.dgx), sel(dginit, st.dgy)
    st.width, st.width1 = sel(big, st.width), sel(2.0 * big, st.width1)
    st.brackt = sel(torch.zeros_like(st.brackt), st.brackt)
    st.stage1 = sel(torch.ones_like(st.stage1), st.stage1)
    st.ls_nfev = sel(torch.zeros_like(st.ls_nfev), st.ls_nfev)
    st.info = sel(info0, st.info)
    st.infoc = sel(torch.ones_like(st.infoc), st.infoc)
    st.dginit = sel(dginit, st.dginit)
    st.dgtest = sel(FTOL * dginit, st.dgtest)
    st.gamma = sel(new_gamma, st.gamma)
    st.count = sel(new_count, count)
    st.s, st.y = s_o, y_o
    st.facc = sel(f1, st.facc)
    st.gacc = torch.where(col(boundary), g1, st.gacc)
    st.g0 = torch.where(col(boundary), g1, st.g0)
    st.f0 = sel(f1, st.f0)
    st.sdir = torch.where(col(boundary), ls_dir, st.sdir)
    st.x0 = torch.where(col(boundary), x1, st.x0)
    st.status = status
    next_stp = torch.where(status == CONTINUE, st.stp, torch.zeros_like(f1))
    return st.x0 + col(next_stp) * st.sdir


def replay(points, values, grads, m, max_fev, crit=Stopping()):
    """Follow a solver step by step: ``points`` ``(T, B, n)`` are the
    points it evaluated, row 0 the starts, and ``values`` ``(T, B)`` and
    ``grads`` ``(T, B, n)`` what its evaluation gave there.  Returns ``(T,
    B, n)``: row k the trial point this trip makes after ``points[k]``, from
    the state that the first k + 1 evaluations led to.  Where the solver's
    trip is right, row k equals its ``points[k + 1]`` but for rounding, and
    that rounding does not pile up over the trips."""
    return torch.stack(list(follow(points, values, grads, m, max_fev, crit)))


def follow(points, values, grads, m, max_fev, crit=Stopping()):
    """:func:`replay` one trip at a time: yields its rows in turn, each
    evaluation taken to float64 as it is reached, so that beside the
    solver's points only the carry is held in float64."""
    f64 = torch.float64
    st, x = init_state(points[0].to(f64), values[0].to(f64),
                       grads[0].to(f64), m, max_fev)
    yield x
    for k in range(1, points.shape[0]):
        yield trip(st, values[k].to(f64), grads[k].to(f64),
                   points[k].to(f64), crit, max_fev)
