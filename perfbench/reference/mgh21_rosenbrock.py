"""MGH problem 21, the extended Rosenbrock function, in plain PyTorch.

Moré, Garbow and Hillstrom, "Testing Unconstrained Optimization Software",
ACM TOMS 7(1):17-41, 1981, problem 21: n even, residuals
``f_{2i-1} = 10 (x_{2i} - x_{2i-1}^2)`` and ``f_{2i} = 1 - x_{2i-1}``,
``F(x) = sum f_k^2``; minimum ``F = 0`` at ``x* = (1, ..., 1)``.  The value
and the analytic gradient below are written from those residuals, in
float64, independent of the solver under test.
"""

from __future__ import annotations

import torch

F_STAR = 0.0
X_STAR = 1.0


def value_and_grad(x: torch.Tensor):
    """``(B, n) -> ((B,), (B, n))`` in float64, rows in blocks so the
    temporaries stay small."""
    x = x.to(torch.float64)
    f = torch.empty(x.shape[0], dtype=torch.float64, device=x.device)
    g = torch.empty_like(x)
    rows = max(1, (1 << 24) // max(x.shape[1], 1))
    for i in range(0, x.shape[0], rows):
        odd, even = x[i:i + rows, 0::2], x[i:i + rows, 1::2]  # x_{2i-1}, x_{2i}
        r = 10.0 * (even - odd * odd)
        t = 1.0 - odd
        f[i:i + rows] = torch.sum(r * r + t * t, dim=-1)
        g[i:i + rows, 0::2] = -40.0 * odd * r - 2.0 * t
        g[i:i + rows, 1::2] = 20.0 * r
    return f, g
