"""Batched lognormal-CDF curve fitting, in PyTorch.

Counterpart of ``nerf_prv_tpu/labeling/lognormal.py``, which replaces the
reference's OriginPro ``LognormalCDF`` fit (``NeRF_fit_curve.cpp:119-147``):
the model

    y = y0 + A * Phi((ln x - mu) / sigma)

is fit to each object's PSNR(views) samples by damped Gauss-Newton
(Levenberg-Marquardt), in float32.  Here all B curves are one (B, n)
tensor program: a fixed ``n_iter`` steps with acceptance masking, an
analytic Jacobian, and batched 4x4 solves through
``torch.linalg.solve_ex(check_errors=False)``, so no step reads anything
back to the host.  ``torch.erf`` and ``jax.lax.erf`` may differ in the last
ulp, so near convergence an accept/reject decision can differ from the
reference's: the two agree to a tolerance, not bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class FitResult(NamedTuple):
    params: torch.Tensor     # (..., 4): y0, A, mu, sigma
    cost: torch.Tensor       # (...,) final SSE
    converged: torch.Tensor  # (...,) bool: LM reached a stationary point


_SQRT2 = math.sqrt(2.0)
# dPhi/dz = exp(-z^2 / 2) / sqrt(2 pi), written as the reference's autodiff of
# 0.5 * erf(z / sqrt 2) takes it: 0.5 * (2 / sqrt pi) * exp(-t^2) / sqrt 2
_DPHI = 0.5 * (2.0 / math.sqrt(math.pi)) / _SQRT2


def _phi(z: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(z / _SQRT2))


def lognormal_cdf(x: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """y0 + A * Phi((ln x - mu) / |sigma|); params (..., 4), x (n,) -> (..., n)."""
    y0, a, mu, sigma = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    z = (torch.log(x) - mu[..., None]) / torch.abs(sigma[..., None])
    return y0[..., None] + a[..., None] * _phi(z)


def _init_params(x: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """(B, 4) start: y0 = min, A = range + 1e-3, mu = ln x where y is
    nearest the midpoint (the first such x), sigma = 1."""
    y0 = ys.min(dim=-1).values
    a = ys.max(dim=-1).values - y0 + 1e-3
    mid = y0 + 0.5 * a
    idx = torch.argmin(torch.abs(ys - mid[:, None]), dim=-1)
    mu = torch.log(x[idx])
    return torch.stack([y0, a, mu, torch.ones_like(y0)], dim=-1)


def _residuals_and_jacobian(x, ys, theta):
    """r (B, n) and dr/dtheta (B, n, 4)."""
    y0, a, mu, sigma = (theta[:, i : i + 1] for i in range(4))
    z = (torch.log(x) - mu) / torch.abs(sigma)
    t = z / _SQRT2
    phi = 0.5 * (1.0 + torch.erf(t))
    dens = _DPHI * torch.exp(-t * t)
    r = y0 + a * phi - ys
    jac = torch.stack(
        [torch.ones_like(r), phi, -a * dens / torch.abs(sigma), -a * dens * z / sigma], dim=-1
    )
    return r, jac


def _cost(x, ys, theta):
    r = lognormal_cdf(x, theta) - ys
    return torch.sum(r * r, dim=-1)


def fit_batch(x, ys, n_iter: int = 100, device="cuda") -> FitResult:
    """LM fits of ``ys`` (B, n) against the shared ``x`` (n,), on ``device``.

    Every curve takes the same ``n_iter`` steps; a step is kept only where
    it lowers the curve's cost and is finite, and the damping falls by 0.3
    on a kept step and rises by 3 on a rejected one (≙ ``fit_lognormal``).
    """
    device = torch.device(device)
    x = torch.as_tensor(np.asarray(x, np.float32), device=device)
    ys = torch.as_tensor(np.asarray(ys, np.float32), device=device)
    ys = ys.reshape(-1, x.shape[0])
    b = ys.shape[0]
    theta = _init_params(x, ys)
    lam = torch.full((b,), 1e-3, dtype=torch.float32, device=device)
    prev = _cost(x, ys, theta)
    eye = torch.eye(4, dtype=torch.float32, device=device)
    gnorm = torch.zeros((b,), dtype=torch.float32, device=device)
    for _ in range(n_iter):
        r, jac = _residuals_and_jacobian(x, ys, theta)
        jt = jac.transpose(1, 2)
        h = jt @ jac
        g = (jt @ r[..., None])[..., 0]
        h_damped = h + lam[:, None, None] * torch.diag_embed(torch.diagonal(h, dim1=1, dim2=2)) + 1e-9 * eye
        delta = torch.linalg.solve_ex(h_damped, g[..., None], check_errors=False).result[..., 0]
        cand = theta - delta
        c_new = _cost(x, ys, cand)
        accept = (c_new < prev) & torch.isfinite(cand).all(dim=-1)
        theta = torch.where(accept[:, None], cand, theta)
        lam = torch.where(accept, torch.clamp_min(lam * 0.3, 1e-9), torch.clamp_max(lam * 3.0, 1e7))
        prev = torch.where(accept, c_new, prev)
        gnorm = torch.linalg.vector_norm(g, dim=-1)
    converged = (
        torch.isfinite(prev)
        & torch.isfinite(theta).all(dim=-1)
        & (gnorm < 1e-1 * (1.0 + torch.sqrt(prev)))
    )
    theta = torch.cat([theta[:, :3], torch.abs(theta[:, 3:])], dim=-1)
    return FitResult(theta, prev, converged)


def fit_lognormal(x, y, n_iter: int = 100, device="cuda") -> FitResult:
    """LM fit of a single curve ``y`` (n,): a batch of one."""
    res = fit_batch(x, np.asarray(y)[None], n_iter=n_iter, device=device)
    return FitResult(res.params[0], res.cost[0], res.converged[0])


def eval_curve(params, x_eval) -> np.ndarray:
    """Evaluate fitted curves (params (4,) or (B, 4)) at ``x_eval``, in float32."""
    p = torch.as_tensor(params).to(torch.float32)
    p = torch.atleast_2d(p)
    x = torch.as_tensor(np.asarray(x_eval, np.float32), device=p.device)
    return lognormal_cdf(x, p).cpu().numpy()
