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

Layout is batch-major: vectors ``(B, n)``, history ``(B, m, n)``, the
plateau ring ``(B, 8)`` and all per-lane scalars packed into ``sf (B, 19)``
(float) and ``si (B, 13)`` (int32).  Rows 0-11 of ``si`` and all of ``sf``
have the row indices of the JAX kernel, so they compare one to one; row 12
is the head of the history ring.  Inside the loop the history is a ring:
row k in age order (0 the oldest) is physical row ``(head + k) mod m``, and
an accepted pair writes one row and, once the history is full, advances the
head, where the JAX kernel shifts every row.  :func:`flat_lbfgs_solve`
returns the history in chronological order (one gather at exit), as the
JAX kernel leaves it.

One semantic difference from the JAX flat kernel, on purpose: ``infoc``
(``cstep``'s case code) is carried across trips of a search as MINPACK and
the JAX nested path do (``where(searching, infoc_new, infoc)``).  The JAX
flat kernel never carries it (its ``ops/flat_solve.py:556``), so a lane
whose ``cstep`` reports an input error there runs on to ``max_fev``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import spans
from ..core.objective import FunctionState
from ..core.progress import (
    PAST_RING_SIZE,
    ProgressState,
    StoppingCriteria,
    update_progress,
)
from ..core.status import Status
from ..core.tree import any_lane
from .two_loop import (
    push_gate,
    search_direction,
    two_loop_direction_reference,
)
from ._kernel import (
    SMEM_LIMIT as _SMEM_LIMIT,
    check_args,
    check_float,
    lane_mapping,
    launch,
    mapping_smem_bytes,
)
from ..linesearch.more_thuente import (
    _FTOL,
    _STPMAX,
    _STPMIN,
    trial_setup,
    trip_step,
)

__all__ = [
    "FlatState",
    "init_flat_state",
    "flat_trip",
    "flat_trip_reference",
    "flat_lbfgs_solve",
    "flat_trip_smem_bytes",
    "history_in_age_order",
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
_I_HEAD = 12     # history ring: physical row of the oldest pair
_NI = 13

_CONT = int(Status.CONTINUE)


@dataclasses.dataclass
class FlatState:
    """The loop carry; ``flat_trip`` updates it in place."""

    x0: torch.Tensor    # (B, n) current iterate
    g0: torch.Tensor    # (B, n) its gradient
    sdir: torch.Tensor  # (B, n) search direction
    gacc: torch.Tensor  # (B, n) gradient at the accepted trial
    s: torch.Tensor     # (B, m, n) history, a ring from si[:, _I_HEAD]
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


def history_in_age_order(buf, head):
    """The ring ``buf`` ``(B, m, n)`` with row k at physical row
    ``(head + k) mod m``, as a chronological ``(B, m, n)`` tensor."""
    m = buf.shape[1]
    rows = (head.long()[:, None]
            + torch.arange(m, device=buf.device)[None, :]) % m
    return torch.gather(buf, 1, rows[..., None].expand(-1, -1, buf.shape[2]))


def flat_trip_smem_bytes(m: int, n: int, itemsize: int) -> int:
    """Shared memory of the ``flat_trip`` block of a one-lane batch under
    :func:`~._kernel.lane_mapping`'s choice; the wrapper raises above
    ``_SMEM_LIMIT``."""
    return mapping_smem_bytes("flat_trip", 1, n, m, itemsize)


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
    b = x0.shape[0]
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
    stage1_i = irow(_I_STAGE1)
    ls_nfev = irow(_I_LSNFEV)
    infoc = irow(_I_INFOC)

    # --- More-Thuente trip (more_thuente.h:199-252) -----------------------
    nfev1 = ls_nfev + 1
    step = trip_step(
        f0, dginit, dgtest, f_t, _rdot(g_t, sdir), stp, stmin, stmax, stx,
        fx, dgx, sty, fy, dgy, width, width1, irow(_I_BRACKT), stage1_i,
        nfev1, infoc, max_fev,
    )
    info_new = step.info
    searching = active & (info_new == 0)

    def upd(new, old):
        return torch.where(searching, new, old)

    stp1 = upd(step.stp, stp)
    stmin1 = upd(step.stmin, stmin)
    stmax1 = upd(step.stmax, stmax)
    stx1 = upd(step.stx, stx)
    fx1 = upd(step.fx, fx)
    dgx1 = upd(step.dgx, dgx)
    sty1 = upd(step.sty, sty)
    fy1 = upd(step.fy, fy)
    dgy1 = upd(step.dgy, dgy)
    width_1 = upd(step.width, width)
    width1_1 = upd(step.width1, width1)
    brackt1 = upd(step.brackt, irow(_I_BRACKT))
    stage1_1 = upd(step.stage1, stage1_i)
    infoc1 = upd(step.infoc, infoc)  # the MINPACK carry (see module note)
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

    # The push into the ring: one row, at the age ``count`` slot, or over
    # the oldest row of a full history, whose head then moves on.
    m = st.s.shape[1]
    head = irow(_I_HEAD)
    accept, full, new_count, new_gamma = push_gate(
        count, frow(_F_GAMMA), s_new, y_new, valid, m)
    slot = torch.where(full, head, (head + count) % m)
    new_head = torch.where(accept & full, (head + 1) % m, head)
    rows = torch.arange(m, device=x0.device)
    write = (accept[:, None] & (slot[:, None] == rows[None, :]))[..., None]
    s_o = torch.where(write, s_new[:, None, :], st.s)
    y_o = torch.where(write, y_new[:, None, :], st.y)
    q = two_loop_direction_reference(
        g1, history_in_age_order(s_o, new_head),
        history_in_age_order(y_o, new_head), new_count, new_gamma)

    ls_dir_new, alpha0, dginit_new, invalid = search_direction(
        x1, g1, q, new_count)
    new_count = torch.where(invalid & push_live, ifull(0), new_count)
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
    sf_new[_F_GAMMA] = sel3(new_gamma, frow(_F_GAMMA))
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
    si_new[_I_HEAD] = sel3(new_head, head)

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
    check_float("flat_trip", dtype)
    dev = check_args("flat_trip", {
        "x0": (st.x0, (b, n), dtype), "g0": (st.g0, (b, n), dtype),
        "sdir": (st.sdir, (b, n), dtype), "gacc": (st.gacc, (b, n), dtype),
        "s": (st.s, (b, m, n), dtype), "y": (st.y, (b, m, n), dtype),
        "ring": (st.ring, (b, PAST_RING_SIZE), dtype),
        "sf": (st.sf, (b, _NF), dtype), "si": (st.si, (b, _NI), torch.int32),
        "f_t": (f_t, (b,), dtype), "g_t": (g_t, (b, n), dtype),
        "x_trial": (x_trial, (b, n), dtype),
    })
    return dev, b, m, n


def crit_scalars(stopping: StoppingCriteria) -> tuple:
    """The criteria in the order the kernels' C entry points take them."""
    return (
        stopping.x_delta, stopping.f_delta, stopping.past_delta,
        stopping.gradient_norm,
        stopping.max_iterations, stopping.x_delta_violations,
        stopping.f_delta_violations, stopping.past,
        int(stopping.f_delta_relative),
        int(stopping.gradient_norm_relative),
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
    dev, b, m, n = _check_trip_args(st, f_t, g_t, x_trial)
    if b == 0:
        return
    if dev.type == "cpu":
        flat_trip_reference(st, f_t, g_t, x_trial, stopping, max_fev)
        return
    mapping = lane_mapping("flat_trip", b, n, m, st.x0.element_size())
    launch(
        "flat_trip", dev, st.x0.dtype,
        (st.x0, st.g0, st.sdir, st.gacc, st.s, st.y, st.ring, st.sf, st.si,
         f_t, g_t, x_trial),
        (b, n, m, int(max_fev), *mapping.scalars(),
         *crit_scalars(stopping)),
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
    trip=None,
) -> FlatSolveResult:
    """Run the flat batched solve from the evaluated batched start
    ``state0`` (B, n).  ``trip`` is :func:`flat_trip` (the default: the
    kernel on CUDA tensors) or :func:`flat_trip_reference` (the plain
    version anywhere).

    Under :func:`~..core.spans.record_spans` the carry's set-up is span
    ``cns.init``, each trip's status read, evaluation and step ``cns.read``,
    ``cns.eval`` and ``cns.trip``, and the result's assembly
    ``cns.assemble``; without a recorder the loop reads no clock."""
    if trip is None:
        trip = flat_trip
    rec = spans.recorder()
    with spans.span(spans.INIT):
        st, x_trial = init_flat_state(state0, m, max_fev)
    dtype = st.x0.dtype
    trips = 0
    t = spans.clock_ns() if rec is not None else 0
    while True:
        # One device-to-host read per trip: the any-lane-continuing
        # predicate.
        go = any_lane(st.si[:, _I_STATUS] == _CONT)
        if rec is not None:
            t = rec.add(spans.READ, t, spans.clock_ns())
        if not go:
            break
        f_t, g_t = objective.batched_value_and_grad(x_trial)
        if rec is not None:
            t = rec.add(spans.EVAL, t, spans.clock_ns())
        trip(st, f_t.to(dtype).contiguous(), g_t.to(dtype).contiguous(),
             x_trial, stopping, max_fev)
        if rec is not None:
            t = rec.add(spans.TRIP, t, spans.clock_ns())
        trips += 1

    with spans.span(spans.ASSEMBLE):
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
        head = st.si[:, _I_HEAD]
        return FlatSolveResult(
            state=state, progress=progress,
            s=history_in_age_order(st.s, head),
            y=history_in_age_order(st.y, head),
            count=st.si[:, _I_COUNT].clone(),
            gamma=st.sf[:, _F_GAMMA].clone(), trips=trips,
        )
