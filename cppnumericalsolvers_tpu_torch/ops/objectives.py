"""Closed-form batched values and gradients of the port's own objectives,
with their plain versions.

``pairwise_rosenbrock_value_and_grad`` is the batched value and gradient of
MGH problem 21 (``models.pairwise_rosenbrock``), which that objective's
function carries: ``Objective.batched_value_and_grad`` calls it in place of
``torch.func.vmap(grad_and_value(fn))``.  For CUDA tensors it is one launch
of ``csrc/pairwise_rosenbrock.cu``, which reads x once and writes g and f
once; for CPU tensors its plain version, which gives the vmap path's bits.
The kernel replaces no Pallas kernel: the JAX package's evaluation is XLA's
fusion of ``jax.vmap(jax.value_and_grad(fn))``.
"""

from __future__ import annotations

import torch

from ..core.tree import fixed_sum
from ._kernel import check_args, check_float, launch

__all__ = [
    "pairwise_rosenbrock_mapping",
    "pairwise_rosenbrock_value_and_grad",
    "pairwise_rosenbrock_value_and_grad_reference",
]

_THREADS = 256  # csrc/pairwise_rosenbrock.cu THREADS


def pairwise_rosenbrock_value_and_grad_reference(x: torch.Tensor):
    """``(B, n) -> ((B,), (B, n))``: the value ``sum_i 100 (x[2i+1] -
    x[2i]^2)^2 + (1 - x[2i])^2`` of every row, summed by ``fixed_sum`` as
    the function sums it, and its gradient in the order in which autograd
    rounds it (``pow``'s backward ``grad * (2 * self)``, the negations of
    ``sub``'s and ``rsub``'s, the two uses of ``x[2i]`` added), plus 0 as
    the slice backward's scatter into zeros adds it.  On the CPU both are
    bit for bit ``vmap(grad_and_value(fn))``'s."""
    e, o = x[..., 0::2], x[..., 1::2]
    r = o - e * e
    t = 1.0 - e
    f = fixed_sum(100.0 * (r * r) + t * t)
    go = 100.0 * (2.0 * r)
    ge = -go * (2.0 * e) + -(2.0 * t)
    return f, torch.stack((ge, go), dim=-1).reshape(x.shape) + 0.0


def pairwise_rosenbrock_mapping(n: int, dtype) -> tuple:
    """``(pairs a unit, threads a lane)`` of the kernel at width ``n``: a
    unit is 16 bytes of a row (two float32 pairs where n is a multiple of 4,
    one float64 pair) or else one float32 pair; a lane gets the power of two
    at or above its row's units, at most 256 threads.  Both follow from n
    and the dtype alone, and with them the order of the value's sum."""
    per_unit = 2 if dtype == torch.float32 and n % 4 == 0 else 1
    units = max(1, n // (2 * per_unit))
    return per_unit, min(_THREADS, 1 << (units - 1).bit_length())


def pairwise_rosenbrock_value_and_grad(x: torch.Tensor):
    """:func:`pairwise_rosenbrock_value_and_grad_reference` of a float32 or
    float64 ``(B, n)`` batch, n even: one launch of
    ``csrc/pairwise_rosenbrock.cu`` on the current stream for a CUDA tensor
    (the gradient the vmap path's bits; the value summed in an order fixed
    by n, so a lane's bits do not depend on B), the plain version for a CPU
    tensor.  A non-contiguous x is made contiguous first.
    ``pairwise_rosenbrock_value_and_grad.launches`` counts kernel
    launches."""
    if x.dim() != 2 or x.shape[1] % 2:
        raise ValueError("pairwise_rosenbrock: x must be (B, n) with n even, "
                         f"got shape {tuple(x.shape)}")
    check_float("pairwise_rosenbrock", x.dtype)
    x = x.contiguous()
    if x.device.type == "cpu":
        return pairwise_rosenbrock_value_and_grad_reference(x)
    b, n = x.shape
    per_unit, tpl = pairwise_rosenbrock_mapping(n, x.dtype)
    if x.data_ptr() % 16:
        # The kernel's 16-byte loads; a fresh allocation is aligned.
        x = x.clone()
    f = torch.empty(b, dtype=x.dtype, device=x.device)
    g = torch.empty_like(x)
    dev = check_args("pairwise_rosenbrock", {
        "x": (x, (b, n), x.dtype), "g": (g, (b, n), x.dtype),
        "f": (f, (b,), x.dtype)})
    launch("pairwise_rosenbrock", dev, x.dtype, (x, g, f),
           (b, n, per_unit, tpl))
    pairwise_rosenbrock_value_and_grad.launches += 1
    return f, g


pairwise_rosenbrock_value_and_grad.launches = 0
