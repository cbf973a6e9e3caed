"""Batched More-Thuente line search: one loop at batch level.

PyTorch counterpart of ``cppnumericalsolvers_tpu/ops/fused_linesearch.py``.
The search of a whole batch is one loop whose trip is::

    batched objective evaluation (torch.func.vmap)  ->  ONE mt_trip call

and which runs while any lane's MINPACK ``info`` is 0, which costs one
device-to-host read per trip.

Three parts:

* :func:`mt_trip_reference` -- the plain PyTorch version of one
  post-evaluation trip, a counterpart of the JAX package's ``_mt_trip_core``:
  the directional derivative, the termination ladder (more_thuente.h:205-216),
  the stage-1 frame and ``cstep`` (:221-244), forced bisection and widths
  (:246-252), the per-lane freeze and the next trial point (:178-195).  It is
  what CPU tensors run, and the version the CUDA kernel is held against on
  the card.
* :func:`mt_trip` -- the wrapper of the hand-written CUDA kernel
  (``csrc/mt_trip.cu``).  CPU tensors take the plain version; CUDA tensors
  launch the kernel or raise.
* :func:`batched_more_thuente` -- the loop with its trip-0 set-up and final
  selection.

The carry (:class:`SearchState`) is updated in place: the trial point and
the accepted gradient ``(B, n)``, and the per-lane scalars packed into
``sf (B, 15)`` (float) and ``si (B, 5)`` (int32).  A lane whose search is
over keeps every bit of its carry.  ``infoc`` (``cstep``'s case code) is
carried across trips as MINPACK does.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.tree import any_lane, lane_sum, model_group
from ..linesearch.more_thuente import (
    _FTOL,
    _STPMAX,
    _STPMIN,
    DEFAULT_MAX_FEV,
    trial_setup,
    trip_step,
)
from ._kernel import check_args, check_float, lane_mapping, launch

__all__ = [
    "SearchState",
    "init_search",
    "mt_trip",
    "mt_trip_reference",
    "batched_more_thuente",
]

# Packed float scalar rows: three that a search never changes, then the
# carry in the JAX kernel's order.
_F_FINIT = 0
_F_DGINIT = 1
_F_DGTEST = 2
_F_FACC = 3      # f at the last evaluated trial
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
_NF = 15

# Packed int32 scalar rows.
_I_BRACKT = 0
_I_STAGE1 = 1
_I_NFEV = 2
_I_INFO = 3
_I_INFOC = 4
_NI = 5


@dataclasses.dataclass
class SearchState:
    """The search loop's carry; ``mt_trip`` updates it in place."""

    x_trial: torch.Tensor  # (B, n) the next point to evaluate
    gacc: torch.Tensor     # (B, n) gradient at the last evaluated trial
    sf: torch.Tensor       # (B, _NF) float scalars
    si: torch.Tensor       # (B, _NI) int32 scalars

    def clone(self) -> "SearchState":
        return SearchState(
            **{f.name: getattr(self, f.name).clone()
               for f in dataclasses.fields(self)}
        )


def _rdot(a, b):
    return lane_sum(a * b)


def init_search(x0, f0, g0, direction, alpha_init, dginit,
                max_fev: int = DEFAULT_MAX_FEV) -> SearchState:
    """The carry before the first evaluation (the loop's first top-of-loop
    pass, more_thuente.h:150-195).  Lanes with ``dginit >= 0`` abort here
    with info -1 and keep ``alpha_init`` as their step."""
    b = x0.shape[0]
    dtype, dev = x0.dtype, x0.device
    i32 = torch.int32
    finit = f0.to(dtype)
    dgin = dginit.to(dtype)
    alpha0 = torch.broadcast_to(
        torch.as_tensor(alpha_init, dtype=dtype, device=dev), (b,))
    zero = torch.zeros((b,), dtype=dtype, device=dev)
    zero_i = torch.zeros((b,), dtype=i32, device=dev)

    stp_t0, stmin0, stmax0 = trial_setup(
        alpha0, zero, zero, torch.zeros((b,), dtype=torch.bool, device=dev),
        zero_i, zero_i + 1, max_fev,
    )
    no_descent = dgin >= 0.0
    stp0 = torch.where(no_descent, alpha0, stp_t0)
    width0 = torch.full((b,), _STPMAX - _STPMIN, dtype=dtype, device=dev)

    sf = torch.empty((b, _NF), dtype=dtype, device=dev)
    for j, v in {
        _F_FINIT: finit, _F_DGINIT: dgin, _F_DGTEST: _FTOL * dgin,
        _F_FACC: finit, _F_STP: stp0, _F_STMIN: stmin0, _F_STMAX: stmax0,
        _F_STX: zero, _F_FX: finit, _F_DGX: dgin,
        _F_STY: zero, _F_FY: finit, _F_DGY: dgin,
        _F_WIDTH: width0, _F_WIDTH1: 2.0 * width0,
    }.items():
        sf[:, j] = v
    si = torch.zeros((b, _NI), dtype=i32, device=dev)
    si[:, _I_STAGE1] = 1
    si[:, _I_INFO] = torch.where(no_descent, zero_i - 1, zero_i)
    si[:, _I_INFOC] = 1
    return SearchState(
        x_trial=x0 + stp0[:, None] * direction,
        # Lanes that abort without an evaluation return the start gradient.
        gacc=g0.clone(),
        sf=sf,
        si=si,
    )


def mt_trip_reference(x0, sdir, f_t, g_t, st: SearchState,
                      max_fev: int = DEFAULT_MAX_FEV) -> None:
    """One post-evaluation trip in plain PyTorch, in place on ``st``.
    ``f_t``/``g_t`` are the objective at ``st.x_trial``; ``x0`` and ``sdir``
    are the search's start and direction."""
    sf, si = st.sf, st.si
    nfev_in, info_in = si[:, _I_NFEV], si[:, _I_INFO]
    active = info_in == 0  # lanes still searching this trip
    nfev1 = nfev_in + 1
    step = trip_step(
        *(sf[:, j] for j in (_F_FINIT, _F_DGINIT, _F_DGTEST)), f_t,
        _rdot(g_t, sdir),
        *(sf[:, j] for j in range(_F_STP, _NF)),
        si[:, _I_BRACKT], si[:, _I_STAGE1], nfev1, si[:, _I_INFOC], max_fev,
    )
    # Lanes that go on searching take the new bracketing state and a fresh
    # trial; lanes that terminate keep the step they evaluated.
    searching = active & (step.info == 0)

    sf_new = [sf[:, j] for j in range(_NF)]
    sf_new[_F_FACC] = torch.where(active, f_t, sf[:, _F_FACC])
    for j, new in (
        (_F_STP, step.stp), (_F_STMIN, step.stmin), (_F_STMAX, step.stmax),
        (_F_STX, step.stx), (_F_FX, step.fx), (_F_DGX, step.dgx),
        (_F_STY, step.sty), (_F_FY, step.fy), (_F_DGY, step.dgy),
        (_F_WIDTH, step.width), (_F_WIDTH1, step.width1),
    ):
        sf_new[j] = torch.where(searching, new, sf[:, j])
    stp_out = sf_new[_F_STP]
    si_new = [None] * _NI
    si_new[_I_BRACKT] = torch.where(searching, step.brackt, si[:, _I_BRACKT])
    si_new[_I_STAGE1] = torch.where(searching, step.stage1, si[:, _I_STAGE1])
    si_new[_I_NFEV] = torch.where(active, nfev1, nfev_in)
    si_new[_I_INFO] = torch.where(active, step.info, info_in)
    # The MINPACK carry of cstep's case code.
    si_new[_I_INFOC] = torch.where(searching, step.infoc, si[:, _I_INFOC])

    act = active[:, None]
    st.x_trial.copy_(
        torch.where(act, x0 + stp_out[:, None] * sdir, st.x_trial))
    st.gacc.copy_(torch.where(act, g_t, st.gacc))
    st.sf.copy_(torch.stack(sf_new, dim=1))
    st.si.copy_(torch.stack(si_new, dim=1))


def mt_trip(x0, sdir, f_t, g_t, st: SearchState,
            max_fev: int = DEFAULT_MAX_FEV) -> None:
    """One trip, in place on ``st``.  CPU tensors run
    :func:`mt_trip_reference`; CUDA tensors launch the kernel of
    ``csrc/mt_trip.cu`` on the current stream, lanes mapped to threads by
    :func:`~._kernel.lane_mapping`, or raise.  ``mt_trip.launches`` counts
    kernel launches."""
    b, n = x0.shape
    dtype = x0.dtype
    check_float("mt_trip", dtype)
    dev = check_args("mt_trip", {
        "x0": (x0, (b, n), dtype), "sdir": (sdir, (b, n), dtype),
        "f_t": (f_t, (b,), dtype), "g_t": (g_t, (b, n), dtype),
        "gacc": (st.gacc, (b, n), dtype),
        "x_trial": (st.x_trial, (b, n), dtype),
        "sf": (st.sf, (b, _NF), dtype), "si": (st.si, (b, _NI), torch.int32),
    })
    if b == 0:
        return
    if dev.type == "cpu":
        mt_trip_reference(x0, sdir, f_t, g_t, st, max_fev)
        return
    mapping = lane_mapping("mt_trip", b, n, 0, x0.element_size())
    launch("mt_trip", dev, dtype,
           (x0, sdir, f_t, g_t, st.gacc, st.x_trial, st.sf, st.si),
           (b, n, int(max_fev), *mapping.scalars()))
    _mt_trip_wrapper.launches += 1


mt_trip.launches = 0
# batched_more_thuente looks ``mt_trip`` up by name at every call; the
# wrapper counts on itself whatever that name stands for then.
_mt_trip_wrapper = mt_trip


def batched_more_thuente(
    batched_value_and_grad,
    x0,
    f0,
    g0,
    direction,
    alpha_init,
    dginit,
    max_fev: int = DEFAULT_MAX_FEV,
    plain: bool = False,
):
    """Strong-Wolfe search of every lane of a batch along ``direction``
    ``(B, n)`` from the populated start ``(x0, f0, g0)``, with ``dginit`` the
    directional derivatives ``g0 . direction``.

    Every trip is one :func:`mt_trip` call; with ``plain``, and inside
    ``core.tree.model_axis_group`` (where the kernel's directional
    derivative would cover one rank's shard only), one
    :func:`mt_trip_reference` call on any device.  Returns
    ``(x, f, g, alpha, nfev, info, trips)``: the accepted point of each lane
    with the evaluations it took and its MINPACK code, and the number of
    loop trips (batched evaluations).  A lane that aborts before its first
    evaluation (``dginit >= 0``) returns its start with info -1 and nfev 0.
    """
    x0, direction = x0.contiguous(), direction.contiguous()
    dtype = x0.dtype
    st = init_search(x0, f0, g0, direction, alpha_init, dginit, max_fev)
    trips = 0
    trip = (mt_trip_reference if plain or model_group() is not None
            else mt_trip)
    # One device-to-host read per trip: the any-lane-searching predicate.
    while any_lane(st.si[:, _I_INFO] == 0):
        f_t, g_t = batched_value_and_grad(st.x_trial)
        trip(x0, direction, f_t.to(dtype).contiguous(),
                g_t.to(dtype).contiguous(), st, max_fev)
        trips += 1
    nfev = st.si[:, _I_NFEV].clone()
    # Lanes that never evaluated return the start.
    x = torch.where((nfev > 0)[:, None], st.x_trial, x0)
    return (x, st.sf[:, _F_FACC].clone(), st.gacc, st.sf[:, _F_STP].clone(),
            nfev, st.si[:, _I_INFO].clone(), trips)
