"""Small utilities over the port's dataclasses of tensors.

PyTorch counterpart of ``cppnumericalsolvers_tpu/core/tree.py``.  The port's
records (``FunctionState``, ``ProgressState``, ``LbfgsInternals``, ...) are
dataclasses whose fields are tensors, other such dataclasses, or plain
Python values; these helpers walk them as ``jax.tree.map`` walks a pytree.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

__all__ = [
    "all_gather_cat",
    "any_lane",
    "fixed_sum",
    "lane_amax",
    "lane_amin",
    "lane_any",
    "lane_gram",
    "lane_lexmin",
    "lane_matvec",
    "lane_sum",
    "masked_while",
    "model_axis_group",
    "model_cut",
    "model_gather",
    "model_group",
    "model_shard",
    "model_sum",
    "model_width",
    "shard_sizes",
    "strided_sum",
    "tree_map",
    "tree_where",
]

#: The process group over which a lane's n-vector is sharded, set only by
#: ``parallel.minimize_model_sharded`` through :func:`model_axis_group`;
#: None everywhere else.
_MODEL_GROUP = None
#: This rank's shard of the n axis inside :func:`model_axis_group`: the
#: global index of its first element and the global n.
_MODEL_SHARD = (0, None)


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every tensor leaf of ``tree`` (and the matching
    leaves of ``rest``); tuples and dataclasses are walked, anything else
    passes through from ``tree``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if type(tree) is tuple:
        return tuple(tree_map(fn, t, *r) for t, *r in zip(tree, *rest))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{
            f.name: tree_map(
                fn, getattr(tree, f.name),
                *(getattr(r, f.name) for r in rest),
            )
            for f in dataclasses.fields(tree)
        })
    return tree


def tree_where(pred, if_true, if_false):
    """Leafwise ``where(pred, a, b)`` with one predicate entry per lane:
    ``pred`` has the leaves' leading (batch) shape and broadcasts over their
    trailing dimensions.  It is how finished lanes of a batch are frozen."""

    def pick(a, b):
        p = pred.reshape(pred.shape + (1,) * (a.dim() - pred.dim()))
        return torch.where(p, a, b)

    return tree_map(pick, if_true, if_false)


def any_lane(mask: torch.Tensor) -> bool:
    """Whether any lane of ``mask`` is set: the predicate of a loop at batch
    level, and one device-to-host read.  ``any_lane.reads`` counts them."""
    any_lane.reads += 1
    return bool(mask.any())


any_lane.reads = 0


def masked_while(cond, body, carry, live):
    """A ``lax.while_loop`` as ``vmap`` runs it, at batch level over the
    lanes of ``live`` ``(B,)``: ``body(carry, active)`` runs while any live
    lane's ``cond(carry)`` holds (one device-to-host read a pass), and a lane
    whose ``cond`` is false keeps its carry, by ``torch.where``, so what the
    body computes for it (a NaN or an inf included) never reaches it.
    ``active`` tells the body which lanes it runs for, e.g. to restrict a
    loop nested in it."""
    while True:
        active = live & cond(carry)
        if not any_lane(active):
            return carry
        carry = tree_where(active, body(carry, active), carry)


@contextlib.contextmanager
def model_axis_group(group, offset: int = 0, n: int | None = None):
    """Within this context every lane's n-vector is sharded over the ranks
    of ``group`` (a ``torch.distributed`` process group), this rank's shard
    starting at global index ``offset`` of ``n``: :func:`lane_sum`,
    :func:`model_sum`, :func:`lane_amax`, :func:`lane_amin` and
    :func:`lane_any` follow their local reduction with an ``all_reduce``
    over it, :func:`lane_lexmin` picks over the ranks, and the More-Thuente
    search takes its plain trip, whose directional derivative is a
    :func:`lane_sum` (the ``mt_trip`` kernel reduces over the local shard
    only)."""
    global _MODEL_GROUP, _MODEL_SHARD
    outer = _MODEL_GROUP, _MODEL_SHARD
    _MODEL_GROUP, _MODEL_SHARD = group, (offset, n)
    try:
        yield
    finally:
        _MODEL_GROUP, _MODEL_SHARD = outer


def model_group():
    """The process group of the enclosing :func:`model_axis_group`, or
    None."""
    return _MODEL_GROUP


def model_shard() -> tuple[int, int | None]:
    """``(offset, n)`` of the enclosing :func:`model_axis_group`: the global
    index of this rank's first element and the global n."""
    return _MODEL_SHARD


def model_width(local: int) -> int:
    """The global n of a lane whose shard is ``local`` wide: ``local``
    outside :func:`model_axis_group`."""
    return local if _MODEL_SHARD[1] is None else _MODEL_SHARD[1]


def shard_sizes(n: int, parts: int) -> list[int]:
    """DTensor's ``Shard`` split of ``n`` over ``parts`` ranks: contiguous
    blocks of ``ceil(n / parts)``, the last ones shorter or empty."""
    chunk = -(-n // parts)
    return [max(0, min(chunk, n - r * chunk)) for r in range(parts)]


def all_gather_cat(t: torch.Tensor, group, dim: int = 0,
                   sizes: list[int] | None = None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order of
    ``group``: one ``all_gather``.  ``sizes`` gives each rank's extent
    along ``dim`` where they differ (each is padded to the largest for the
    gather and trimmed after)."""
    world = dist.get_world_size(group)
    dim = dim % t.dim()
    src = t
    if sizes is not None:
        pad = max(sizes) - t.shape[dim]
        if pad:
            shape = list(t.shape)
            shape[dim] = pad
            src = torch.cat([t, t.new_zeros(shape)], dim=dim)
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src, group=group)
    if sizes is not None:
        parts = [p.narrow(dim, 0, k) for p, k in zip(parts, sizes)]
    return torch.cat(parts, dim=dim)


def _model_sizes() -> list[int]:
    return shard_sizes(_MODEL_SHARD[1], dist.get_world_size(_MODEL_GROUP))


def model_gather(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard ``t`` of a last axis split as a lane's n-vector is
    made whole on every rank by one ``all_gather`` over the model group;
    ``t`` itself outside :func:`model_axis_group`."""
    if _MODEL_GROUP is None:
        return t
    return all_gather_cat(t, _MODEL_GROUP, -1, _model_sizes())


def model_cut(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """This rank's shard of a whole axis ``dim`` (the last by default) of
    global length n: the inverse of :func:`model_gather`, with no
    collective; ``t`` itself outside :func:`model_axis_group`."""
    if _MODEL_GROUP is None:
        return t
    size = _model_sizes()[dist.get_rank(_MODEL_GROUP)]
    return t.narrow(dim, _MODEL_SHARD[0], size)


def model_sum(s: torch.Tensor) -> torch.Tensor:
    """Per-rank partial sums ``s`` (any shape, e.g. a lane's products over
    its shard) summed elementwise over the model group by one
    ``all_reduce``; ``s`` itself outside :func:`model_axis_group`."""
    if _MODEL_GROUP is not None:
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=_MODEL_GROUP)
    return s


def lane_sum(x: torch.Tensor) -> torch.Tensor:
    """``torch.sum(x, -1)``: a per-lane sum over the n axis (a dot product
    is ``lane_sum(a * b)``).  Inside :func:`model_axis_group` the local sums
    are then summed over the group by one ``all_reduce``."""
    return model_sum(torch.sum(x, dim=-1))


#: Rows of fewer than this many values are summed by one ``torch.sum``.
#: On the card PyTorch reduces such a contiguous row with one warp, in an
#: order set by the row's length alone; a longer row is split over as many
#: threads, warps or blocks as the number of rows leaves room for, so its
#: order (and its last bits) depends on the batch.
_FIXED_ROW = 64
_FIXED_CHUNK = 32


def fixed_sum(x: torch.Tensor) -> torch.Tensor:
    """``torch.sum(x, -1)`` in an order fixed by the length of the last axis
    alone, whatever the leading (batch) shape, so that a lane's sum has the
    same bits in a batch of any size.  A row shorter than 64 is one
    ``torch.sum`` (bit for bit); a longer one is cut into chunks of 32,
    zero-padded at its end, each chunk summed, and the chunk sums summed the
    same way in turn.  A per-lane product ``a @ b`` is ``fixed_sum`` of the
    elementwise product over the contracted axis: unlike a batched
    ``matmul``, whose library picks its algorithm by the batch count, its
    bits do not depend on the batch.  The card and the CPU add a row in
    different orders; :func:`strided_sum` adds alike on both."""
    x = x.contiguous()
    while x.shape[-1] >= _FIXED_ROW:
        pad = -x.shape[-1] % _FIXED_CHUNK
        if pad:
            x = torch.nn.functional.pad(x, (0, pad))
        x = torch.sum(x.view(*x.shape[:-1], -1, _FIXED_CHUNK), dim=-1)
    return torch.sum(x, dim=-1)


#: Values of the elementwise product that one slice of :func:`lane_matvec`
#: or :func:`lane_gram` holds at most (more rows go slice by slice): 2**24,
#: 64 MiB in float32, whatever the batch and the width.
_PRODUCT_VALUES = 1 << 24


def _row_slices(rows: int, per_row: int):
    step = max(1, _PRODUCT_VALUES // max(per_row, 1))
    return [(i, min(i + step, rows)) for i in range(0, rows, step)]


def lane_matvec(a: torch.Tensor, v: torch.Tensor, total=fixed_sum
                ) -> torch.Tensor:
    """``a @ v`` lane by lane, ``(B, r, k), (B, k) -> (B, r)``: the
    elementwise product summed over k by ``total`` (:func:`fixed_sum`, or
    :func:`strided_sum` for a short k), so a lane's bits do not depend on
    its batch (a batched ``matmul``'s library picks its algorithm by the
    batch count).  Rows go in slices whose product holds at most 2**24
    values, one slice where they fit: the temporary stays ``a``'s size or
    less, and each row's sum is the same whatever the slice."""
    r = a.shape[-2]
    parts = [total(a[..., i:j, :] * v[..., None, :])
             for i, j in _row_slices(r, a.numel() // max(r, 1))]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def lane_gram(a: torch.Tensor, b: torch.Tensor, total=fixed_sum
              ) -> torch.Tensor:
    """``a @ b^T`` lane by lane, ``(B, r, k), (B, s, k) -> (B, r, s)``, as
    :func:`lane_matvec` sums: ``a``'s rows go in slices whose product holds
    at most 2**24 values (one row's product is ``b``'s size)."""
    parts = [total(a[..., i:j, None, :] * b[..., None, :, :])
             for i, j in _row_slices(a.shape[-2], b.numel())]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)


#: The width of :func:`strided_sum`'s partial sums.
_STRIDE = 4


def strided_sum(x: torch.Tensor) -> torch.Tensor:
    """``torch.sum(x, -1)`` of a short row in an explicit order, by
    elementwise adds alone, so its bits depend neither on the batch nor on
    the device: the row's leading multiple of four is read as groups of
    four, each group added lane-wise to the one four groups before it into
    up to four running groups, which are then added in turn; the tail (the
    last ``k mod 4`` values) is summed first, and the four lanes of the
    combined group are added to it one by one.  For float64 rows shorter
    than 24 this is the order in which PyTorch's AVX-vectorised CPU sum
    adds them, so on such a CPU the results keep ``torch.sum``'s bits, and
    the card gives the same bits.  Each add is one launch: meant for rows
    of a few values, such as L-BFGS-B's 2m slots."""
    k = x.shape[-1]
    if k == 0:
        return torch.sum(x, dim=-1)
    body = k - k % _STRIDE
    total = None
    for t in range(body, k):
        total = x[..., t] if total is None else total + x[..., t]
    if body:
        groups = [x[..., i:i + _STRIDE] for i in range(0, body, _STRIDE)]
        running = groups[:_STRIDE]
        for i, g in enumerate(groups[_STRIDE:]):
            running[i % _STRIDE] = running[i % _STRIDE] + g
        acc = running[0]
        for r in running[1:]:
            acc = acc + r
        for j in range(_STRIDE):
            total = acc[..., j] if total is None else total + acc[..., j]
    return total


def _group_reduce(s: torch.Tensor, op) -> torch.Tensor:
    dist.all_reduce(s, op=op, group=_MODEL_GROUP)
    return s


def lane_amax(x: torch.Tensor) -> torch.Tensor:
    """``torch.amax(x, -1)`` of non-negative values ``x`` (magnitudes): a
    per-lane infinity norm over the n axis.  Inside
    :func:`model_axis_group` the local maxima (0 on a rank whose shard is
    empty) are then maximised over the group by one ``all_reduce``."""
    if _MODEL_GROUP is None:
        return torch.amax(x, dim=-1)
    s = (torch.amax(x, dim=-1) if x.shape[-1]
         else x.new_zeros(x.shape[:-1]))
    return _group_reduce(s, dist.ReduceOp.MAX)


def lane_amin(x: torch.Tensor) -> torch.Tensor:
    """``torch.amin(x, -1)`` of floating values: a per-lane minimum over the
    n axis.  Inside :func:`model_axis_group` the local minima (+inf on a
    rank whose shard is empty) are then minimised over the group by one
    ``all_reduce``."""
    if _MODEL_GROUP is None:
        return torch.amin(x, dim=-1)
    s = (torch.amin(x, dim=-1) if x.shape[-1]
         else x.new_full(x.shape[:-1], float("inf")))
    return _group_reduce(s, dist.ReduceOp.MIN)


def lane_any(mask: torch.Tensor) -> torch.Tensor:
    """``mask.any(-1)``: whether any element of a lane's n-vector is set.
    Inside :func:`model_axis_group` the local answers are then or-ed over
    the group by one ``all_reduce``."""
    if _MODEL_GROUP is None:
        return mask.any(dim=-1)
    s = mask.any(dim=-1).to(torch.int32)
    return _group_reduce(s, dist.ReduceOp.MAX) > 0


def lane_lexmin(t: torch.Tensor, idx: torch.Tensor):
    """Lane-wise lexicographic minimum of ``(t, idx)`` over the ranks of the
    model group: each rank gives one ``(t, idx)`` pair a lane (``(B,)``
    each; ``idx`` integral), and every rank gets back the pair with the
    smallest ``t``, ties going to the smallest ``idx`` (``-0.0`` ties with
    ``0.0``), with the winner's own bits.  One ``all_gather`` of the ranks'
    pairs, then the same pick on every rank.  Outside
    :func:`model_axis_group` it returns ``(t, idx)``."""
    if _MODEL_GROUP is None:
        return t, idx
    # float64 holds float32 values and indices below 2**53 exactly.
    pair = torch.stack([t.to(torch.float64), idx.to(torch.float64)], dim=-1)
    parts = [torch.empty_like(pair)
             for _ in range(dist.get_world_size(_MODEL_GROUP))]
    dist.all_gather(parts, pair.contiguous(), group=_MODEL_GROUP)
    every = torch.stack(parts)  # (W, B, 2)
    ts, ids = every[..., 0], every[..., 1]
    low = ts == torch.amin(ts, dim=0)
    win = torch.argmin(torch.where(low, ids, torch.inf), dim=0)[None]
    return (torch.gather(ts, 0, win)[0].to(t.dtype),
            torch.gather(ids, 0, win)[0].to(idx.dtype))
