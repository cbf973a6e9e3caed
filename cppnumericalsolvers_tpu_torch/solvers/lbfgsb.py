"""L-BFGS-B: box-constrained limited-memory BFGS (Byrd-Lu-Nocedal-Zhu),
batched.

PyTorch counterpart of ``cppnumericalsolvers_tpu/solvers/lbfgsb.py`` (the
reference's include/cppoptlib/solver/lbfgsb.h:44-534), with the JAX
package's storage and arithmetic:

* the (s, y) history lives in fixed ``(B, m, n)`` buffers with the newest
  pair last and slots ``m - count .. m - 1`` valid (lbfgsb.h:212-220);
* the middle matrix is a fixed ``(B, 2m, 2m)`` array whose invalid slots are
  identity rows and columns, inverted once per accepted step by the unrolled
  Gauss-Jordan of ``utils/linalg.py``, so every solve with it is a matvec
  (lbfgsb.h:229-235, 311-316);
* the generalized-Cauchy-point breakpoint walk (lbfgsb.h:318-430) is one
  loop at batch level over the sorted breakpoints (``core/tree.py::
  masked_while``, one device-to-host read a pass), a lane leaving it by
  ``torch.where`` when its walk ends, as the JAX package's batched rule
  runs it; the coordinate examined is picked by ``torch.gather``;
* free variables are boolean masks, so the subspace minimization
  (lbfgsb.h:459-515, with the paper's sign fix at :502) is a fixed
  ``(2m, 2m)`` solve however many variables are free.

The search runs the batched More-Thuente of ``ops/fused_linesearch.py``, so
on the card every search trip is one ``mt_trip`` launch.  The
projected-gradient test (lbfgsb.h:247-292) goes through the driver's
``transform_stopping`` and ``post_update`` hooks, the Fortran-factr relative
f-delta default (lbfgsb.h:84-87) through ``default_stopping``.

The JAX package evaluates the objective in places whose result it does not
bill or keep (at an unmoved projected start, and at the clipped point of a
lane that was not clipped); the port skips those evaluations and bills as
the JAX package does.  Lanes that are done, and lanes with no free variable
(which take the Cauchy point with one evaluation), are left out of the walk
and the search.
"""

from __future__ import annotations

import dataclasses
import numbers

import numpy as np
import torch

from ..core.driver import SolverBase
from ..core.objective import FunctionState, Objective
from ..core.progress import ProgressState, StoppingCriteria, default_stopping
from ..core.status import Status
from ..core.tree import any_lane, masked_while, tree_where
from ..linesearch.more_thuente import DEFAULT_MAX_FEV
from ..ops.fused_linesearch import batched_more_thuente
from ..utils.linalg import invert_small, solve_small

__all__ = ["Lbfgsb", "LbfgsbInternals", "projected_gradient_inf_norm",
           "generalized_cauchy_point"]

_CAUCHY_EPS = 1e-12  # f'' floor (lbfgsb.h:324)


def projected_gradient_inf_norm(x, gradient, lower, upper):
    """Sup-norm of the box-projected gradient over the last dimension
    (lbfgsb.h:105-118): components pointing out of the box at an active
    bound are zeroed."""
    g = gradient
    zero = torch.zeros_like(g)
    g = torch.where((x <= lower) & (g > 0), zero, g)
    g = torch.where((x >= upper) & (g < 0), zero, g)
    return torch.amax(torch.abs(g), dim=-1)


@dataclasses.dataclass
class LbfgsbInternals:
    """The JAX package's ``LbfgsbInternals`` with a leading batch axis."""

    s_history: torch.Tensor  # (B, m, n), newest pair in the last valid slot
    y_history: torch.Tensor  # (B, m, n)
    count: torch.Tensor  # (B,) int32 valid pairs (slots m-count .. m-1)
    theta: torch.Tensor  # (B,) y.y / y.s scaling (lbfgsb.h:222-223)
    middle_inv: torch.Tensor  # (B, 2m, 2m) explicit MM^-1
    projected_gradient_norm: torch.Tensor  # (B,) read by post_update
    lower: torch.Tensor  # (B, n) box bounds, per lane (lbfgsb.h:124-130)
    upper: torch.Tensor  # (B, n)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _matvec(a, v):
    return torch.matmul(a, v[..., None])[..., 0]


def _build_w(internals: LbfgsbInternals) -> torch.Tensor:
    """W = [Y  theta*S] as ``(B, n, 2m)``; invalid slots are zero columns
    (lbfgsb.h:224-226)."""
    return torch.cat(
        [internals.y_history.transpose(-1, -2),
         internals.theta[:, None, None]
         * internals.s_history.transpose(-1, -2)],
        dim=-1,
    )


def _build_middle(s_history, y_history, count, theta, m):
    """MM = [[-D, L^T], [L, theta S^T S]] with identity rows and columns on
    invalid slots (lbfgsb.h:227-235).  The zero-padded buffers give the
    reference's k x k blocks because invalid slots hold zero vectors."""
    dtype, dev = s_history.dtype, s_history.device
    a = s_history @ y_history.transpose(-1, -2)  # (B, m, m) S^T Y
    low = torch.tril(a, diagonal=-1)
    d = torch.diag_embed(torch.diagonal(a, dim1=-2, dim2=-1))
    ss = s_history @ s_history.transpose(-1, -2)
    top = torch.cat([-d, low.transpose(-1, -2)], dim=-1)
    bottom = torch.cat([low, theta[:, None, None] * ss], dim=-1)
    mm = torch.cat([top, bottom], dim=-2)
    slot_valid = (torch.arange(m, device=dev)[None, :]
                  >= (m - count)[:, None])
    valid2 = torch.cat([slot_valid, slot_valid], dim=-1)
    both = valid2[:, :, None] & valid2[:, None, :]
    return torch.where(both, mm, torch.eye(2 * m, dtype=dtype, device=dev))


@dataclasses.dataclass
class _CauchyCarry:
    i: torch.Tensor  # (B,) int64 position in sorted breakpoint order
    b: torch.Tensor  # (B,) int64 coordinate being examined
    t: torch.Tensor  # its breakpoint
    t_old: torch.Tensor
    dt: torch.Tensor
    dt_min: torch.Tensor
    x_cauchy: torch.Tensor  # (B, n)
    c: torch.Tensor  # (B, 2m)
    p: torch.Tensor  # (B, 2m)
    d: torch.Tensor  # (B, n)
    f_prime: torch.Tensor
    f_dprime: torch.Tensor


def _pick(vec, idx):
    """``vec[lane, idx[lane]]`` for every lane: ``(B, n), (B,) -> (B,)``."""
    return torch.gather(vec, -1, idx[:, None])[:, 0]


def generalized_cauchy_point(x, gradient, lower, upper, w, middle_inv,
                             theta, live=None):
    """Piecewise-quadratic search along the projected steepest-descent path
    of every lane (lbfgsb.h:318-430); returns ``(x_cauchy, c)``.

    MM is symmetric, so every quadratic form ``w^T MM^-1 v`` of the
    breakpoint recurrences comes from the one per-pass product ``MM^-1
    w_b``.  The breakpoints are sorted stably (``jnp.argsort`` is stable):
    every coordinate with a zero gradient has the breakpoint ``finfo.max``,
    and tied coordinates must be visited in index order.  One pass of the
    loop crosses one breakpoint of every lane still walking; lanes outside
    ``live`` ``(B,)`` do not walk.  ``generalized_cauchy_point.passes``
    counts passes."""
    b_, n = x.shape
    dtype, dev = x.dtype, x.device
    big = torch.finfo(dtype).max
    one = torch.ones((), dtype=dtype, device=dev)

    nonzero = torch.where(gradient == 0, one, gradient)
    t = torch.where(
        gradient == 0,
        torch.full_like(x, big),
        torch.where(gradient < 0, (x - upper) / nonzero,
                    (x - lower) / nonzero),
    )
    d = torch.where((gradient != 0) & (t == 0), torch.zeros_like(x),
                    -gradient)
    order = torch.argsort(t, dim=-1, stable=True)  # ascending breakpoints
    rank = torch.argsort(order, dim=-1, stable=True)

    p = _matvec(w.transpose(-1, -2), d)  # (B, 2m)
    c = torch.zeros_like(p)
    f_prime = -_dot(d, d)
    f_dprime = torch.maximum(
        torch.full_like(f_prime, _CAUCHY_EPS),
        -theta * f_prime - _dot(p, _matvec(middle_inv, p)),
    )
    dt_min = -f_prime / f_dprime

    # First sorted position with a positive breakpoint, or n - 1 if none.
    pos = torch.gather(t, -1, order) > 0
    i0 = torch.where(pos.any(dim=-1),
                     torch.argmax(pos.to(torch.int32), dim=-1),
                     torch.full((b_,), n - 1, dtype=torch.int64, device=dev))
    b0 = _pick(order, i0)
    t0 = _pick(t, b0)
    carry = _CauchyCarry(
        i=i0, b=b0, t=t0, t_old=torch.zeros_like(t0), dt=t0, dt_min=dt_min,
        x_cauchy=x, c=c, p=p, d=d, f_prime=f_prime, f_dprime=f_dprime,
    )
    f_dp_orig = f_dprime
    lanes = torch.arange(n, device=dev)

    def walking(s):
        return (s.dt_min >= s.dt) & (s.i < n)

    def body(s, active):
        del active
        generalized_cauchy_point.passes += 1
        b = s.b
        oh = lanes[None, :] == b[:, None]
        db = _pick(s.d, b)
        gb = _pick(gradient, b)
        # Pin the coordinate crossing its bound (lbfgsb.h:383-386).
        xc_b = torch.where(db > 0, _pick(upper, b),
                           torch.where(db < 0, _pick(lower, b),
                                       _pick(s.x_cauchy, b)))
        x_cauchy = torch.where(oh, xc_b[:, None], s.x_cauchy)
        zb = xc_b - _pick(x, b)
        c_new = s.c + s.dt[:, None] * s.p
        wbt = torch.gather(
            w, 1, b[:, None, None].expand(b_, 1, w.shape[-1]))[:, 0]
        mwbt = _matvec(middle_inv, wbt)
        f_prime = (s.f_prime + s.dt * s.f_dprime + gb * gb
                   + theta * gb * zb - gb * _dot(mwbt, c_new))
        f_dprime = (s.f_dprime - theta * gb * gb
                    - 2.0 * gb * _dot(mwbt, s.p) - gb * gb * _dot(wbt, mwbt))
        f_dprime = torch.maximum(_CAUCHY_EPS * f_dp_orig, f_dprime)
        p_new = s.p + gb[:, None] * wbt
        d_new = torch.where(oh, torch.zeros_like(s.d), s.d)
        dt_min = -f_prime / f_dprime
        i = s.i + 1
        b_next = _pick(order, torch.clamp(i, max=n - 1))
        t_next = _pick(t, b_next)
        in_range = i < n
        return _CauchyCarry(
            i=i,
            b=torch.where(in_range, b_next, s.b),
            t=torch.where(in_range, t_next, s.t),
            t_old=s.t,
            dt=torch.where(in_range, t_next - s.t, s.dt),
            dt_min=dt_min, x_cauchy=x_cauchy, c=c_new, p=p_new, d=d_new,
            f_prime=f_prime, f_dprime=f_dprime,
        )

    if live is None:
        live = torch.ones((b_,), dtype=torch.bool, device=dev)
    fin = masked_while(walking, body, carry, live)

    # Final drift of the coordinates not pinned in the loop
    # (lbfgsb.h:417-427).
    dt_min = torch.clamp(fin.dt_min, min=0.0)
    t_old = fin.t_old + dt_min
    drift = rank >= fin.i[:, None]
    x_cauchy = torch.where(drift, x + t_old[:, None] * fin.d, fin.x_cauchy)
    return x_cauchy, fin.c + dt_min[:, None] * fin.p


generalized_cauchy_point.passes = 0


def _subspace_minimization(x, gradient, x_cauchy, c, lower, upper, w,
                           middle_inv, theta):
    """Direct primal subspace minimization over the free variables
    (lbfgsb.h:459-515), masked instead of gathered.  Returns the subspace
    minimizer and whether each lane has a free variable."""
    dtype, dev = x.dtype, x.device
    two_m = w.shape[-1]
    free = (x_cauchy != upper) & (x_cauchy != lower)
    theta_inv = 1.0 / theta
    rr = (gradient + theta[:, None] * (x_cauchy - x)
          - _matvec(w, _matvec(middle_inv, c)))
    r = torch.where(free, rr, torch.zeros_like(rr))

    # v = M^-1 (W_F^T r); N = I - M^-1 (theta^-1 W_F^T W_F)
    # (lbfgsb.h:484-495), W_F being W with its bound rows zeroed.
    wf = w * free[:, :, None].to(dtype)
    wft = wf.transpose(-1, -2)
    v = _matvec(middle_inv, _matvec(wft, r))
    nn = theta_inv[:, None, None] * (wft @ wf)
    nn = torch.eye(two_m, dtype=dtype, device=dev) - middle_inv @ nn
    v = solve_small(nn, v)

    # The sign-fixed step (lbfgsb.h:500-504).
    du = (-theta_inv[:, None] * r
          - (theta_inv * theta_inv)[:, None] * _matvec(wf, v))

    # alpha* = max {a <= 1 : l - xc <= a du <= u - xc} over free
    # coordinates (lbfgsb.h:435-457).
    consider = free & (torch.abs(du) >= 1e-7)
    safe = torch.where(du == 0, torch.ones_like(du), du)
    ratio = torch.where(du > 0, (upper - x_cauchy) / safe,
                        (lower - x_cauchy) / safe)
    ratio = torch.where(consider, ratio, torch.full_like(ratio, float("inf")))
    alpha_star = torch.clamp(torch.amin(ratio, dim=-1), max=1.0)
    subspace_min = torch.where(free, x_cauchy + alpha_star[:, None] * du,
                               x_cauchy)
    return subspace_min, free.any(dim=-1)


def _bound_field(val):
    """A bound as the JAX package keeps it: None, a float, or a tuple of
    floats (hashable)."""
    if val is None or isinstance(val, numbers.Real):
        return val
    arr = np.asarray(torch.as_tensor(val).cpu(), dtype=np.float64)
    return float(arr) if arr.ndim == 0 else tuple(arr.reshape(-1).tolist())


@dataclasses.dataclass(frozen=True)
class Lbfgsb(SolverBase):
    """Box-constrained L-BFGS-B (default history m=5, lbfgsb.h:44).

    ``lower``/``upper`` are scalars or per-coordinate sequences, stored as
    floats or tuples; None is the unbounded side (lbfgsb.h:124-130).  A box
    per lane goes in at run time through :meth:`make_internals`."""

    m: int = 5
    lower: tuple | float | None = None
    upper: tuple | float | None = None
    max_linesearch_fev: int = DEFAULT_MAX_FEV

    #: The step leaves done lanes out of the walk and the search and returns
    #: their internals bit-identical; the driver selects state and progress.
    freeze_in_step: bool = dataclasses.field(
        default=True, init=False, repr=False
    )

    def __post_init__(self):
        for name in ("lower", "upper"):
            object.__setattr__(self, name, _bound_field(getattr(self, name)))

    def _bounds(self, n, dtype, device="cpu"):
        """The config box as two ``(n,)`` tensors."""
        big = torch.finfo(dtype).max

        def side(val, default):
            v = default if val is None else val
            return torch.broadcast_to(
                torch.as_tensor(v, dtype=dtype, device=device), (n,))

        return side(self.lower, -big), side(self.upper, big)

    def make_internals(self, n: int, dtype=torch.float64, lower=None,
                       upper=None, *, batch: int | None = None,
                       device="cpu") -> LbfgsbInternals:
        """Fresh internals, optionally with a box given at run time.

        ``lower``/``upper`` (default: the config box) broadcast to ``(n,)``,
        or are ``(B, n)``: one box per lane, for ``minimize_batched(...,
        internals=...)`` or ``AugmentedLagrangian(...).minimize_batched(...,
        inner_internals=...)``.  ``batch`` gives a batch axis to a box
        shared by the lanes.  Without either the internals are those of one
        instance, for ``minimize(..., internals=...)``."""
        cfg_lower, cfg_upper = self._bounds(n, dtype, device)
        lower = cfg_lower if lower is None else torch.as_tensor(
            lower, dtype=dtype, device=device)
        upper = cfg_upper if upper is None else torch.as_tensor(
            upper, dtype=dtype, device=device)
        if lower.dim() == 2 or upper.dim() == 2:
            batch = max(lower.shape[0] if lower.dim() == 2 else 0,
                        upper.shape[0] if upper.dim() == 2 else 0)
        lead = () if batch is None else (batch,)
        m = self.m

        def zeros(*shape, dt=dtype):
            return torch.zeros(lead + shape, dtype=dt, device=device)

        eye = torch.eye(2 * m, dtype=dtype, device=device)
        return LbfgsbInternals(
            s_history=zeros(m, n),
            y_history=zeros(m, n),
            count=zeros(dt=torch.int32),
            theta=torch.ones(lead, dtype=dtype, device=device),
            middle_inv=eye.expand(lead + (2 * m, 2 * m)).clone(),
            projected_gradient_norm=torch.full(
                lead, float("inf"), dtype=dtype, device=device),
            lower=torch.broadcast_to(lower, lead + (n,)).clone(),
            upper=torch.broadcast_to(upper, lead + (n,)).clone(),
        )

    def init_batched(self, objective: Objective,
                     state: FunctionState) -> LbfgsbInternals:
        del objective
        b, n = state.x.shape
        return self.make_internals(n, state.x.dtype, batch=b,
                                   device=state.x.device)

    def default_stopping(self, dtype) -> StoppingCriteria:
        # Fortran L-BFGS-B 3.0's factr test (lbfgsb.h:76-87): factr = 1e7,
        # 2.22e-9 relative.
        f32 = dtype in (torch.float32, "float32")
        return default_stopping(dtype).replace(
            f_delta=1.2e-6 if f32 else 2.22e-9, f_delta_relative=True)

    def transform_stopping(self, stopping: StoppingCriteria
                           ) -> StoppingCriteria:
        # The driver's full-gradient test is off; convergence on the
        # gradient comes from the projected-gradient post_update
        # (lbfgsb.h:256-260).
        return stopping.replace(gradient_norm=0.0)

    def post_update(self, objective, state, internals: LbfgsbInternals,
                    progress: ProgressState,
                    stopping: StoppingCriteria) -> ProgressState:
        # Projected-gradient convergence (lbfgsb.h:280-283), on the norm
        # recorded at the start of the step, with the caller's tolerance.
        del objective, state
        if not stopping.gradient_norm > 0:
            return progress
        fire = internals.projected_gradient_norm < stopping.gradient_norm
        return dataclasses.replace(progress, status=torch.where(
            fire,
            torch.full_like(progress.status,
                            int(Status.GRADIENT_NORM_VIOLATION)),
            progress.status))

    def step(self, objective: Objective, state: FunctionState,
             internals: LbfgsbInternals, stopping: StoppingCriteria,
             done: torch.Tensor | None = None):
        """One L-BFGS-B iteration of every lane without the convergence
        test.  Returns ``(next_state, next_internals, evaluations)``;
        ``state`` and ``internals`` are not changed, and a ``done`` lane's
        internals come back bit-identical."""
        del stopping
        it = internals
        lower, upper = it.lower, it.upper
        live = (torch.ones_like(state.value, dtype=torch.bool)
                if done is None else ~done)
        n_eval = 0

        # Project an infeasible iterate into the box and evaluate there if
        # it moved (lbfgsb.h:144-153).
        x = torch.minimum(torch.maximum(state.x, lower), upper)
        moved = (x != state.x).any(dim=-1) & live
        value, gradient, nfev = state.value, state.gradient, state.nfev
        if any_lane(moved):
            value_c, gradient_c = objective.batched_value_and_grad(x)
            n_eval += 1
            value = torch.where(moved, value_c, value)
            gradient = torch.where(moved[:, None], gradient_c, gradient)
            nfev = nfev + moved.to(nfev.dtype)

        proj_norm = projected_gradient_inf_norm(x, gradient, lower, upper)
        w = _build_w(it)
        x_cauchy, c = generalized_cauchy_point(
            x, gradient, lower, upper, w, it.middle_inv, it.theta, live)
        subspace_min, do_line_search = _subspace_minimization(
            x, gradient, x_cauchy, c, lower, upper, w, it.middle_inv,
            it.theta)

        # Line search from the iterate toward the subspace minimizer
        # (lbfgsb.h:186-193).  A lane with no free variable takes the
        # Cauchy point with one evaluation instead; it and the done lanes
        # enter the search with a non-negative slope, which ends their
        # search before it evaluates.
        direction = subspace_min - x
        searching = do_line_search & live
        dginit = torch.where(searching, _dot(gradient, direction),
                             torch.zeros_like(value))
        ls_x, ls_f, ls_g, _, ls_nfev, _, trips = batched_more_thuente(
            objective.batched_value_and_grad, x, value, gradient, direction,
            1.0, dginit, max_fev=self.max_linesearch_fev)
        n_eval += trips
        next_x = torch.where(do_line_search[:, None], ls_x, subspace_min)

        # Clip a step that crossed a bound and evaluate there; where nothing
        # was clipped the search's (f, g) at ls_x stand (lbfgsb.h:199-203).
        clipped = torch.minimum(torch.maximum(next_x, lower), upper)
        was_clipped = (clipped != next_x).any(dim=-1)
        need_eval = (~do_line_search | was_clipped) & live
        next_value, next_gradient = ls_f, ls_g
        if any_lane(need_eval):
            value_c, gradient_c = objective.batched_value_and_grad(clipped)
            n_eval += 1
            next_value = torch.where(need_eval, value_c, next_value)
            next_gradient = torch.where(need_eval[:, None], gradient_c,
                                        next_gradient)
        nfev = nfev + torch.where(
            do_line_search, ls_nfev + was_clipped.to(ls_nfev.dtype),
            torch.ones_like(ls_nfev)).to(nfev.dtype)
        next_state = FunctionState(x=clipped, value=next_value,
                                   gradient=next_gradient, nfev=nfev)

        # Curvature-gated history rebuild: s.y > 1e-7 |y|^2
        # (lbfgsb.h:209-235); a rejected lane keeps its history, theta and
        # middle_inv bit for bit.
        new_s = clipped - x
        new_y = next_gradient - gradient
        s_dot_y = _dot(new_s, new_y)
        y_dot_y = _dot(new_y, new_y)
        accept = s_dot_y > 1e-7 * y_dot_y
        s_h = torch.cat([it.s_history[:, 1:], new_s[:, None]], dim=1)
        y_h = torch.cat([it.y_history[:, 1:], new_y[:, None]], dim=1)
        count = torch.clamp(it.count + 1, max=self.m)
        theta = y_dot_y / s_dot_y
        middle_inv = invert_small(
            _build_middle(s_h, y_h, count, theta, self.m))
        acc1, acc3 = accept, accept[:, None, None]
        new_internals = LbfgsbInternals(
            s_history=torch.where(acc3, s_h, it.s_history),
            y_history=torch.where(acc3, y_h, it.y_history),
            count=torch.where(acc1, count, it.count),
            theta=torch.where(acc1, theta, it.theta),
            middle_inv=torch.where(acc3, middle_inv, it.middle_inv),
            projected_gradient_norm=proj_norm,
            lower=lower,
            upper=upper,
        )
        if done is not None:
            new_internals = tree_where(done, it, new_internals)
        return next_state, new_internals, n_eval
