"""Hager-Zhang (CG_DESCENT 2006) approximate-Wolfe line search, batched.

PyTorch counterpart of ``cppnumericalsolvers_tpu/linesearch/hager_zhang.py``
(the reference's HagerZhang, include/cppoptlib/linesearch/hager_zhang.h:
54-548).  Stage tags (B0-B3 bracket, S1-S4 secant^2, U0-U3 update, L2
bisection fallback) follow the paper's numbering, as there.

The JAX package runs the search per instance, as nested data-dependent
``lax.while_loop``s, and vmaps it: the initial non-finite backoff, the
bracket loop (with B2's bisection and B3's non-finite backoff inside), and
the secant^2 / shrink loop (with the U3 bisection of every update inside).
Here every loop runs at batch level, as a vmapped ``while_loop`` does:

* a loop runs while any lane of it is active, and each pass is one batched
  evaluation of the whole batch (or a fixed number of them) and one
  device-to-host read (:func:`~..core.tree.masked_while`);
* a lane whose predicate is false keeps its carry: every update is a
  ``torch.where`` select, never a multiply by a mask, so a NaN or inf in a
  finished lane's trial cannot leak;
* a nested loop runs only on the lanes whose result its caller keeps (the
  enclosing loop's active lanes, narrowed where a select discards the rest);
  the other lanes' results are discarded there as the vmapped loop's are;
* nfev is each lane's own count of the evaluations its per-instance search
  makes, the JAX package's to the evaluation.

Each sample carries its full gradient, so every acceptance returns the
accepted evaluation's own ``(f, g)`` without another evaluation.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.tree import lane_sum, masked_while, tree_where

__all__ = ["hager_zhang", "HagerZhangResult"]

_DELTA = 0.1  # c1 (sufficient decrease)
_SIGMA = 0.9  # c2 (curvature)
_EPSILON_K = 1e-6  # approximate-Wolfe envelope
_GAMMA = 0.66  # bracket shrink threshold
_RHO = 5.0  # expansion factor
_PSI3 = 0.1  # non-finite backoff
_MAX_LS = 50
_ITER_FINITE_MAX = 60
_BISECT_MAX = 80


@dataclasses.dataclass
class _Trip:
    """One sample of the search, per lane."""

    alpha: torch.Tensor  # (B,)
    phi: torch.Tensor  # (B,)
    dphi: torch.Tensor  # (B,)
    g: torch.Tensor  # (B, n) gradient at x0 + alpha d


@dataclasses.dataclass
class _Bracket:
    prev: _Trip  # most recent sample
    prev2: _Trip  # the sample before it (B1's scan-back target)
    a: _Trip
    b: _Trip
    bracketed: torch.Tensor
    accepted: torch.Tensor  # Wolfe hit during expansion or bisection
    accept_trip: _Trip
    failed: torch.Tensor
    best: _Trip
    nfev: torch.Tensor
    iter: torch.Tensor


@dataclasses.dataclass
class _Shrink:
    a: _Trip
    b: _Trip
    accepted: torch.Tensor
    accept_trip: _Trip
    collapsed: torch.Tensor
    best: _Trip
    nfev: torch.Tensor
    iter: torch.Tensor


@dataclasses.dataclass
class HagerZhangResult:
    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    alpha: torch.Tensor
    nfev: torch.Tensor  # (B,) int32
    ok: torch.Tensor  # (B,) bool: False => no usable step (start returned)
    trips: int = 0  # batched evaluations the search made


def _sel(pred, a, b):
    return tree_where(pred, a, b)


def hager_zhang(
    batched_value_and_grad,
    x0,
    f0,
    g0,
    direction,
    alpha_init=1.0,
    active=None,
) -> HagerZhangResult:
    """Search every lane of ``x0`` ``(B, n)`` along ``direction`` from the
    populated start ``(x0, f0, g0)``; ``alpha_init`` is a scalar or ``(B,)``.
    ``active`` (optional, ``(B,)`` bool) leaves the other lanes out of every
    loop and return with nfev 0; the rest of what they return is
    unspecified."""
    dtype = f0.dtype
    dev = x0.device
    bsz = x0.shape[0]
    eps = torch.finfo(dtype).eps
    s = direction
    live0 = (torch.ones((bsz,), dtype=torch.bool, device=dev)
             if active is None else active)
    alpha_init = torch.broadcast_to(
        torch.as_tensor(alpha_init, dtype=dtype, device=dev), (bsz,))

    phi_0 = f0
    dphi_0 = lane_sum(g0 * s)
    phi_lim = phi_0 + _EPSILON_K * torch.abs(phi_0)
    trips = 0

    def phi_dphi(alpha, nfev):
        nonlocal trips
        f, g = batched_value_and_grad(x0 + alpha[:, None] * s)
        trips += 1
        return _Trip(alpha=alpha, phi=f, dphi=lane_sum(g * s),
                     g=g), nfev + 1

    def finite(t: _Trip):
        return torch.isfinite(t.phi) & torch.isfinite(t.dphi)

    def wolfe(t: _Trip):
        # T1/T2 acceptance (hager_zhang.h:131-140).
        wolfe1 = ((_DELTA * dphi_0 >= (t.phi - phi_0) / t.alpha)
                  & (t.dphi >= _SIGMA * dphi_0))
        wolfe2 = (((2.0 * _DELTA - 1.0) * dphi_0 >= t.dphi)
                  & (t.dphi >= _SIGMA * dphi_0) & (t.phi <= phi_lim))
        return wolfe1 | wolfe2

    def secant(a: _Trip, b: _Trip):
        return (a.alpha * b.dphi - b.alpha * a.dphi) / (b.dphi - a.dphi)

    def better_best(best, t: _Trip):
        return _sel((t.alpha > 0.0) & (t.phi < best.phi), t, best)

    false = torch.zeros((bsz,), dtype=torch.bool, device=dev)
    zero_i = torch.zeros((bsz,), dtype=torch.int32, device=dev)
    zero_trip = _Trip(alpha=torch.zeros((bsz,), dtype=dtype, device=dev),
                      phi=phi_0, dphi=dphi_0, g=g0)

    # -- U3 bisection (hager_zhang.h:186-214) --------------------------------
    def bisect(a: _Trip, b: _Trip, best, nfev, live):
        def cond(c):
            a, b, hit, _, _, it = c
            return (~hit & (b.alpha - a.alpha > eps * b.alpha)
                    & (it < _BISECT_MAX))

        def body(c, _active):
            a, b, _, best, nfev, it = c
            d, nfev = phi_dphi((a.alpha + b.alpha) / 2.0, nfev)
            best = better_best(best, d)
            is_wolfe = wolfe(d)
            slope_up = d.dphi >= 0.0
            low = d.phi <= phi_lim
            # A Wolfe hit returns (a, d); slope_up sets b = d; low sets
            # a = d; else b = d.
            new_b = _sel(is_wolfe | slope_up | ~low, d, b)
            new_a = _sel(~is_wolfe & ~slope_up & low, d, a)
            return (new_a, new_b, is_wolfe, best, nfev, it + 1)

        a, b, hit, best, nfev, _ = masked_while(
            cond, body, (a, b, false, best, nfev, zero_i), live)
        return a, b, hit, best, nfev

    # -- U0-U3 update (hager_zhang.h:162-182) --------------------------------
    def update(a: _Trip, b: _Trip, c: _Trip, best, nfev, live):
        inside = (c.alpha >= a.alpha) & (c.alpha <= b.alpha)
        u1 = c.dphi >= 0.0  # new upper bound
        u2 = c.phi <= phi_lim  # better lower bound
        needs_bisect = inside & ~u1 & ~u2
        # As in the JAX package, the bisection of [a, c] runs, and is billed,
        # whatever the case.
        ba, bb, bhit, best, nfev = bisect(a, c, best, nfev, live)
        # Outside -> (a, b); u1 -> (a, c); u2 -> (c, b); else the bisection.
        new_a = _sel(~inside, a, _sel(u1, a, _sel(u2, c, ba)))
        new_b = _sel(~inside, b, _sel(u1, c, _sel(u2, b, bb)))
        return new_a, new_b, needs_bisect & bhit, best, nfev

    # -- S1-S4 secant^2 (hager_zhang.h:218-275) ------------------------------
    def secant2(a: _Trip, b: _Trip, best, nfev, live):
        c_alpha = secant(a, b)
        c_alpha = torch.where(torch.isfinite(c_alpha), c_alpha,
                              (a.alpha + b.alpha) / 2.0)
        c, nfev = phi_dphi(c_alpha, nfev)
        best = better_best(best, c)
        hit1 = wolfe(c)

        iA, iB, uhit, best, nfev = update(a, b, c, best, nfev, live)
        moved_b = iB.alpha == c.alpha
        moved_a = iA.alpha == c.alpha
        c2_alpha = torch.where(
            moved_b, secant(b, iB),
            torch.where(moved_a, secant(a, iA), c.alpha))
        do_second = ((moved_a | moved_b) & (iA.alpha <= c2_alpha)
                     & (c2_alpha <= iB.alpha))
        # Evaluated on every lane; counted and used where the C++ control
        # flow would evaluate.
        c2, nfev2 = phi_dphi(c2_alpha, nfev)
        nfev = torch.where(do_second, nfev2, nfev)
        best = _sel(do_second, better_best(best, c2), best)
        hit2 = do_second & wolfe(c2)
        iA2, iB2, uhit2, best2, nfev3 = update(iA, iB, c2, best, nfev,
                                               live & do_second)
        uhit2 = do_second & uhit2
        best = _sel(do_second, best2, best)
        nfev = torch.where(do_second, nfev3, nfev)
        new_a = _sel(do_second, iA2, iA)
        new_b = _sel(do_second, iB2, iB)

        # Priority of returns: hit1 (at c) > uhit (the first update's
        # bisection, at its b) > hit2 (at c2) > uhit2.
        any_hit = hit1 | uhit | hit2 | uhit2
        hit_trip = _sel(hit1, c, _sel(uhit, iB, _sel(hit2, c2, iB2)))
        return any_hit, hit_trip, new_a, new_b, best, nfev

    # -- Initial trial with non-finite backoff (hager_zhang.h:333-365) -------
    c_alpha0 = torch.where(alpha_init > 0.0, alpha_init,
                           torch.ones_like(alpha_init))
    ec0, nfev0 = phi_dphi(c_alpha0, zero_i)

    def backoff_body(c, _active):
        ec, nfev, it = c
        new_ec, nfev = phi_dphi(ec.alpha * _PSI3, nfev)
        return new_ec, nfev, it + 1

    ec, nfev, _ = masked_while(
        lambda c: ~finite(c[0]) & (c[2] < _ITER_FINITE_MAX),
        backoff_body, (ec0, nfev0, zero_i), live0)
    initial_finite = finite(ec)
    best = better_best(zero_trip, ec)
    initial_wolfe = initial_finite & wolfe(ec)
    no_descent = dphi_0 >= 0.0

    # -- Bracket phase B0-B3 (hager_zhang.h:367-455) -------------------------
    def bracket_cond(c: _Bracket):
        return ~(c.bracketed | c.accepted | c.failed) & (c.iter < _MAX_LS)

    def bracket_body(c: _Bracket, live) -> _Bracket:
        last = c.prev
        slope_up = last.dphi >= 0.0
        over_peak = last.phi > phi_lim
        is_b1 = slope_up
        is_b2 = ~slope_up & over_peak
        is_b3 = ~slope_up & ~over_peak

        # B2: bisect [0, last].  B3 bills its evaluations too, as in the JAX
        # package; B1 discards them.
        b2_a, b2_b, b2_hit, best2, nfev2 = bisect(
            zero_trip, last, c.best, c.nfev, live & ~is_b1)

        # B3: expand, backing off towards the last sample while non-finite.
        ec3, nfev3 = phi_dphi(last.alpha * _RHO, nfev2)

        def finite_body(cc, _active):
            ec, nfev, it = cc
            new_ec, nfev = phi_dphi((last.alpha + ec.alpha) / 2.0, nfev)
            return new_ec, nfev, it + 1

        ec3, nfev3, _ = masked_while(
            lambda cc: ~finite(cc[0]) & (cc[2] < _ITER_FINITE_MAX),
            finite_body, (ec3, nfev3, zero_i), live & is_b3)
        b3_finite = finite(ec3)
        b3_wolfe = b3_finite & wolfe(ec3)

        return _Bracket(
            prev=_sel(is_b3, ec3, c.prev),
            prev2=_sel(is_b3, c.prev, c.prev2),
            a=_sel(is_b1, c.prev2, _sel(is_b2, b2_a, c.a)),
            b=_sel(is_b1, last, _sel(is_b2, b2_b, c.b)),
            bracketed=is_b1 | is_b2,
            accepted=(is_b2 & b2_hit) | (is_b3 & b3_wolfe),
            accept_trip=_sel(is_b2, b2_b, ec3),
            failed=is_b3 & ~b3_finite,
            best=_sel(is_b3, better_best(c.best, ec3),
                      _sel(is_b2, best2, c.best)),
            nfev=torch.where(is_b3, nfev3, torch.where(is_b2, nfev2, c.nfev)),
            iter=c.iter + 1,
        )

    bres = masked_while(bracket_cond, bracket_body, _Bracket(
        prev=ec, prev2=zero_trip, a=zero_trip, b=ec, bracketed=false,
        accepted=initial_wolfe, accept_trip=ec, failed=~initial_finite,
        best=best, nfev=nfev, iter=zero_i + 1,
    ), live0)

    # -- Main shrinking loop (hager_zhang.h:457-535) -------------------------
    run_shrink = bres.bracketed & ~(bres.accepted | bres.failed)

    def shrink_cond(c: _Shrink):
        return ~(c.accepted | c.collapsed) & run_shrink & (c.iter < _MAX_LS)

    def shrink_body(c: _Shrink, live) -> _Shrink:
        collapsed = c.b.alpha - c.a.alpha <= eps * c.b.alpha
        # A collapsed lane keeps its carry: nothing below is kept for it.
        live = live & ~collapsed
        hit, hit_trip, iA, iB, best, nfev = secant2(
            c.a, c.b, c.best, c.nfev, live)

        # L2 fallback when the shrink was too slow (hager_zhang.h:499-533).
        slow = (iB.alpha - iA.alpha) >= _GAMMA * (c.b.alpha - c.a.alpha)
        use_l2 = ~hit & ~collapsed & slow
        cm, nfev_m = phi_dphi((iA.alpha + iB.alpha) / 2.0, nfev)
        best_m = better_best(best, cm)
        m_hit = wolfe(cm)
        mA, mB, m_uhit, best_m2, nfev_m2 = update(
            iA, iB, cm, best_m, nfev_m, live & use_l2)

        any_hit = hit | (use_l2 & (m_hit | m_uhit))
        accept_trip = _sel(hit, hit_trip, _sel(m_hit, cm, mB))
        new_a = _sel(use_l2, mA, iA)
        new_b = _sel(use_l2, mB, iB)
        best_out = _sel(use_l2, best_m2, best)
        nfev_out = torch.where(use_l2, nfev_m2, nfev)
        return _Shrink(
            a=_sel(collapsed, c.a, new_a),
            b=_sel(collapsed, c.b, new_b),
            accepted=torch.where(collapsed, c.accepted, any_hit),
            accept_trip=_sel(collapsed, c.accept_trip, accept_trip),
            collapsed=collapsed,
            best=_sel(collapsed, c.best, best_out),
            nfev=torch.where(collapsed, c.nfev, nfev_out),
            iter=c.iter + 1,
        )

    sres = masked_while(shrink_cond, shrink_body, _Shrink(
        a=bres.a, b=bres.b, accepted=bres.accepted,
        accept_trip=bres.accept_trip, collapsed=false, best=bres.best,
        nfev=bres.nfev, iter=bres.iter,
    ), live0)

    # -- Final selection ------------------------------------------------------
    # Priority: the Wolfe-accepted sample; else the collapsed interval's a
    # (if > 0); else the best seen (if > 0); else the start (ok = False).
    accepted = bres.accepted | sres.accepted
    accept_trip = _sel(bres.accepted, bres.accept_trip, sres.accept_trip)
    collapse_usable = sres.collapsed & (sres.a.alpha > 0.0)
    usable = accepted | collapse_usable | (sres.best.alpha > 0.0)
    final = _sel(accepted, accept_trip,
                 _sel(collapse_usable, sres.a, sres.best))
    alpha = torch.where(usable, final.alpha, torch.zeros_like(final.alpha))
    ok = ~no_descent & usable
    # The no-descent abort keeps the initial step width and the start state
    # (hager_zhang.h:301-302).
    alpha = torch.where(no_descent, alpha_init, alpha)
    # The accepted sample's own evaluation is the returned state.
    return HagerZhangResult(
        x=torch.where(ok[:, None], x0 + final.alpha[:, None] * s, x0),
        f=torch.where(ok, final.phi, f0),
        g=torch.where(ok[:, None], final.g, g0),
        alpha=alpha,
        nfev=torch.where(live0, sres.nfev, zero_i),
        ok=ok,
        trips=trips,
    )
