"""Convergence state machine and stopping criteria.

PyTorch counterpart of ``cppnumericalsolvers_tpu/core/progress.py`` (the
reference's ``Progress`` machinery, include/cppoptlib/solver/progress.h).

* :class:`StoppingCriteria` holds thresholds as plain Python numbers; a
  solve rounds the float fields to its working dtype where it uses them, as
  the JAX package's ``astype(dtype)`` does.
* :class:`ProgressState` is the live record, one entry per lane.
* :func:`update_progress` mirrors the test order and side effects of
  ``Progress::Update`` (progress.h:153-327): iteration limit, x_delta with
  its violation counter, f_delta (absolute or Fortran-factr relative), the
  plateau ring buffer, the relative gradient norm.  It works on any number
  of leading batch dimensions and is the plain oracle for the ladder inside
  the flat-trip kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from .status import Status
from .tree import lane_amax

__all__ = [
    "PAST_RING_SIZE",
    "StoppingCriteria",
    "ProgressState",
    "default_stopping",
    "conservative_stopping",
    "init_progress",
    "update_progress",
    "update_progress_constrained",
]

# Static capacity of the plateau ring buffer; the dynamic window ``past``
# may be any value in [0, PAST_RING_SIZE].
PAST_RING_SIZE = 8

_INT_FIELDS = frozenset(
    {"max_iterations", "x_delta_violations", "f_delta_violations", "past"}
)
_BOOL_FIELDS = frozenset({"f_delta_relative", "gradient_norm_relative"})


def _cast_field(name: str, value):
    if name in _INT_FIELDS:
        value = int(value)
        if name == "past":
            # An oversized window degrades to the ring's capacity instead of
            # silently disabling the plateau test.
            value = min(value, PAST_RING_SIZE)
        return value
    if name in _BOOL_FIELDS:
        return bool(value)
    return float(value)


@dataclasses.dataclass(frozen=True)
class StoppingCriteria:
    """Stopping thresholds (progress.h:87-140).  A zero/negative threshold
    disables the corresponding test, matching the reference."""

    max_iterations: int
    x_delta: float
    x_delta_violations: int
    f_delta: float
    f_delta_violations: int
    f_delta_relative: bool
    gradient_norm: float
    gradient_norm_relative: bool
    condition_hessian: float
    constraint_threshold: float
    kkt_stationarity_threshold: float
    past: int
    past_delta: float

    def __post_init__(self):
        for f in dataclasses.fields(self):
            object.__setattr__(
                self, f.name, _cast_field(f.name, getattr(self, f.name))
            )

    def replace(self, **kwargs) -> "StoppingCriteria":
        return dataclasses.replace(self, **kwargs)


def _is_f32(dtype) -> bool:
    return dtype in (torch.float32, "float32")


def default_stopping(dtype=torch.float64) -> StoppingCriteria:
    """The default preset (progress.h:353-431); float32 loosens the
    epsilon-scaled thresholds exactly as the JAX package does."""
    f32 = _is_f32(dtype)
    return StoppingCriteria(
        max_iterations=10000,
        x_delta=1e-7 if f32 else 1e-9,
        x_delta_violations=1,
        f_delta=0.0,
        f_delta_violations=1,
        f_delta_relative=False,
        gradient_norm=1e-4 if f32 else 1e-5,
        gradient_norm_relative=True,
        condition_hessian=0.0,
        constraint_threshold=1e-4 if f32 else 1e-5,
        kkt_stationarity_threshold=1e-3 if f32 else 1e-4,
        past=3,
        past_delta=1e-5 if f32 else 1e-6,
    )


def conservative_stopping(dtype=torch.float64) -> StoppingCriteria:
    """Conservative preset (progress.h:456-464): tighter gradient norm,
    deeper plateau window."""
    f32 = _is_f32(dtype)
    return default_stopping(dtype).replace(
        gradient_norm=5e-5 if f32 else 5e-6,
        past=5,
        past_delta=1e-7 if f32 else 1e-10,
    )


@dataclasses.dataclass
class ProgressState:
    """Live convergence record, one entry per lane (leading batch dims)."""

    num_iterations: torch.Tensor  # int32
    x_delta: torch.Tensor
    x_delta_violations: torch.Tensor  # int32
    f_delta: torch.Tensor
    f_delta_violations: torch.Tensor  # int32
    gradient_norm: torch.Tensor
    condition_hessian: torch.Tensor
    status: torch.Tensor  # int32 Status code
    past_ring: torch.Tensor  # (..., PAST_RING_SIZE)
    past_pos: torch.Tensor  # int32


def init_progress(
    batch_shape=(), dtype=torch.float64, device="cpu"
) -> ProgressState:
    """Fresh record with status CONTINUE."""
    shape = tuple(batch_shape)

    def zf():
        return torch.zeros(shape, dtype=dtype, device=device)

    def zi():
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return ProgressState(
        num_iterations=zi(),
        x_delta=zf(),
        x_delta_violations=zi(),
        f_delta=zf(),
        f_delta_violations=zi(),
        gradient_norm=zf(),
        condition_hessian=zf(),
        status=torch.full(
            shape, int(Status.CONTINUE), dtype=torch.int32, device=device
        ),
        past_ring=torch.zeros(
            shape + (PAST_RING_SIZE,), dtype=dtype, device=device
        ),
        past_pos=zi(),
    )


def _first(status, cond, code):
    """Set ``code`` only where still CONTINUE and ``cond`` (the reference's
    early-return ladder)."""
    take = (status == int(Status.CONTINUE)) & cond
    return torch.where(take, torch.full_like(status, int(code)), status)


def update_progress(
    progress: ProgressState,
    prev_state,
    cur_state,
    crit: StoppingCriteria,
    *,
    mode: str = "first",
    condition_hessian=None,
) -> ProgressState:
    """One convergence-test pass; mirrors progress.h:153-327.

    ``prev_state`` / ``cur_state`` are :class:`FunctionState`s with the
    populated (value, gradient) invariant.  ``mode='none'`` skips the
    gradient test.  ``condition_hessian`` is an optional precomputed metric,
    one per lane, for the Hessian-condition test (progress.h:318-325); it is
    stored in the record, and None disables the test and stores zero.
    """
    i32 = torch.int32
    value = cur_state.value
    dtype = value.dtype
    one = torch.ones((), dtype=dtype, device=value.device)
    cont = int(Status.CONTINUE)

    num_iterations = progress.num_iterations + 1
    f_delta = torch.abs(value - prev_state.value)
    x_delta = lane_amax(torch.abs(cur_state.x - prev_state.x))
    if mode == "none":
        gradient_norm = torch.zeros_like(value)
    else:
        gradient_norm = lane_amax(torch.abs(cur_state.gradient))

    if condition_hessian is None:
        cond_h = torch.zeros_like(value)
    else:
        cond_h = torch.broadcast_to(
            torch.as_tensor(condition_hessian, dtype=dtype,
                            device=value.device), value.shape)

    status = torch.full_like(progress.status, cont)

    # 1. Iteration limit (progress.h:212-216).
    status = _first(
        status,
        (crit.max_iterations > 0) & (num_iterations > crit.max_iterations),
        Status.ITERATION_LIMIT,
    )

    # 2. x_delta with consecutive-violation counter (progress.h:254-262).
    reached = status == cont
    x_cond = (crit.x_delta > 0) & (x_delta < crit.x_delta)
    x_viol = torch.where(
        reached,
        torch.where(
            x_cond,
            progress.x_delta_violations + 1,
            torch.zeros_like(progress.x_delta_violations),
        ),
        progress.x_delta_violations,
    ).to(i32)
    status = _first(
        status,
        x_cond & (x_viol >= crit.x_delta_violations),
        Status.X_DELTA_VIOLATION,
    )

    # 3. f_delta, absolute or factr-style relative (progress.h:263-277).
    reached = status == cont
    if crit.f_delta_relative:
        f_scale = torch.maximum(
            torch.maximum(torch.abs(value), torch.abs(prev_state.value)), one
        )
    else:
        f_scale = one
    f_cond = (crit.f_delta > 0) & (f_delta < crit.f_delta * f_scale)
    f_viol = torch.where(
        reached,
        torch.where(
            f_cond,
            progress.f_delta_violations + 1,
            torch.zeros_like(progress.f_delta_violations),
        ),
        progress.f_delta_violations,
    ).to(i32)
    status = _first(
        status,
        f_cond & (f_viol >= crit.f_delta_violations),
        Status.F_DELTA_VIOLATION,
    )

    # 4. Plateau ring buffer (progress.h:280-298): lazy init on the first
    # update, test after `past` iterations, write skipped after an earlier
    # test returned.
    reached = status == cont
    past_active = crit.past > 0
    ring = progress.past_ring
    if past_active:
        ring = torch.where(
            (num_iterations == 1)[..., None], value[..., None], ring
        )
    slots = torch.arange(PAST_RING_SIZE, device=value.device)
    at_pos = slots == progress.past_pos[..., None].long()
    past_f = torch.sum(torch.where(at_pos, ring, torch.zeros_like(ring)), -1)
    rate = torch.abs(past_f - value) / torch.maximum(one, torch.abs(value))
    plateau = past_active & (num_iterations > crit.past) & (
        rate < crit.past_delta
    )
    status = _first(status, plateau, Status.F_DELTA_VIOLATION)
    write_ring = (status == cont) & reached & past_active
    ring = torch.where(at_pos & write_ring[..., None], value[..., None], ring)
    past_pos = torch.where(
        write_ring,
        torch.where(
            progress.past_pos + 1 >= crit.past,
            torch.zeros_like(progress.past_pos),
            progress.past_pos + 1,
        ),
        progress.past_pos,
    ).to(i32)

    # 5. Gradient norm, relative by default (progress.h:299-317).
    if mode != "none":
        if crit.gradient_norm_relative:
            scale = torch.maximum(
                one, lane_amax(torch.abs(cur_state.x))
            )
        else:
            scale = one
        status = _first(
            status,
            (crit.gradient_norm > 0)
            & (gradient_norm < crit.gradient_norm * scale),
            Status.GRADIENT_NORM_VIOLATION,
        )

    # 6. Hessian condition (progress.h:318-325), only when the caller
    # supplied the metric.
    if condition_hessian is not None:
        status = _first(
            status,
            (crit.condition_hessian > 0) & (cond_h > crit.condition_hessian),
            Status.HESSIAN_CONDITION_VIOLATION,
        )

    return ProgressState(
        num_iterations=num_iterations.to(i32),
        x_delta=x_delta,
        x_delta_violations=x_viol,
        f_delta=f_delta,
        f_delta_violations=f_viol,
        gradient_norm=gradient_norm,
        condition_hessian=cond_h,
        status=status,
        past_ring=ring,
        past_pos=past_pos,
    )


def update_progress_constrained(
    progress: ProgressState,
    prev_x,
    cur_x,
    prev_value,
    cur_value,
    gradient_norm,
    max_violation,
    max_lagrangian_gradient,
    crit: StoppingCriteria,
) -> ProgressState:
    """The constrained (augmented-Lagrangian) branch of ``Progress::Update``
    (progress.h:217-253): the iteration limit, then the hard stop on a
    non-finite violation or KKT norm, then feasibility and KKT stationarity
    together give FINISHED, else CONTINUE.  None of the unconstrained delta
    tests apply.  Works on any leading batch dimensions."""
    num_iterations = progress.num_iterations + 1
    f_delta = torch.abs(cur_value - prev_value)
    x_delta = lane_amax(torch.abs(cur_x - prev_x))

    status = torch.full_like(progress.status, int(Status.CONTINUE))
    status = _first(
        status,
        (crit.max_iterations > 0) & (num_iterations > crit.max_iterations),
        Status.ITERATION_LIMIT,
    )
    # The NaN hard stop (progress.h:235-239): nothing of the iterate can be
    # recovered; the outer solver's best-iterate tracker rescues the result.
    non_finite = (~torch.isfinite(max_violation)
                  | ~torch.isfinite(max_lagrangian_gradient))
    status = _first(status, non_finite, Status.ITERATION_LIMIT)
    primal_feasible = torch.abs(max_violation) <= crit.constraint_threshold
    kkt_stationary = (
        max_lagrangian_gradient <= crit.kkt_stationarity_threshold
        if crit.kkt_stationarity_threshold > 0
        else torch.ones_like(primal_feasible))
    status = _first(status, primal_feasible & kkt_stationary,
                    Status.FINISHED)
    return dataclasses.replace(
        progress,
        num_iterations=num_iterations.to(torch.int32),
        x_delta=x_delta,
        f_delta=f_delta,
        gradient_norm=torch.as_tensor(gradient_norm,
                                      dtype=cur_value.dtype).to(
            cur_value.device),
        status=status,
    )
