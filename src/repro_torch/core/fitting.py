"""Minimax (Chebyshev / L-infinity) polynomial fitting — the heart of PolyFit.

The twin of ``repro.core.fitting``.  The paper (Def. 4.1 / Eq. 10) fits,
inside a key interval I holding keys k_1..k_l with exact-function values
F(k_i), the polynomial P minimizing

    E(I) = min_{a} max_i |F(k_i) - P(k_i)|

via a linear program.  Three fitters, as in the reference:

* ``fit_minimax_lp``     — the paper-faithful LP (scipy/HiGHS, exact), on
  the host.
* ``fit_minimax_lawson`` — Lawson's iteratively reweighted least squares in
  torch.  It converges to the same minimax solution and, being a fixed
  sequence of small weighted least-squares solves, batches:
  ``lawson_batched`` fits thousands of candidate intervals in one call on
  the tensors' device (the card in ``parallel_segmentation``).
* ``fit_lstsq``          — plain least squares; a cheap screen (the max
  residual of the L2 fit upper-bounds E(I)).

Keys are rescaled to u = (2k - lo - hi) / (hi - lo) in [-1, 1] per interval
before the Vandermonde system is built; the stored model is
(lo, hi, coeffs-in-u), evaluated by Horner in u.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import DTYPE, resolve_device

__all__ = [
    "PolyModel",
    "rescale",
    "eval_poly",
    "fit_lstsq",
    "fit_minimax_lp",
    "fit_minimax_lawson",
    "lawson_batched",
    "continuum_error",
    "max_error",
]


@dataclasses.dataclass(frozen=True)
class PolyModel:
    """One fitted segment: P(k) = Horner(coeffs, u(k)) on [lo, hi]."""

    lo: float
    hi: float
    coeffs: np.ndarray  # (deg+1,), ascending powers of u
    err: float          # E(I): certified max |F - P| over the fitted keys

    @property
    def deg(self) -> int:
        return len(self.coeffs) - 1

    def __call__(self, k):
        u = rescale(k, self.lo, self.hi)
        return eval_poly(self.coeffs, u)


def rescale(k, lo, hi):
    """Map keys in [lo, hi] to u in [-1, 1] (degenerate interval -> 0)."""
    span = hi - lo
    span = np.where(span <= 0, 1.0, span) if isinstance(span, np.ndarray) else (
        span if span > 0 else 1.0)
    return (2.0 * k - lo - hi) / span


def eval_poly(coeffs, u):
    """Horner evaluation, ascending-power coeffs.  Works for numpy arrays
    and torch tensors (a tensor in either argument gives a tensor)."""
    if isinstance(u, torch.Tensor) or isinstance(coeffs, torch.Tensor):
        u = torch.as_tensor(u)
        coeffs = torch.as_tensor(coeffs, device=u.device)
        acc = torch.zeros_like(u) + coeffs[-1]
    else:
        acc = np.zeros_like(u) + coeffs[-1]
    for j in range(len(coeffs) - 2, -1, -1):
        acc = acc * u + coeffs[j]
    return acc


def _vander(u, deg):
    return np.stack([u**j for j in range(deg + 1)], axis=-1)


def max_error(model: PolyModel, keys: np.ndarray, values: np.ndarray) -> float:
    return float(np.max(np.abs(values - model(keys)))) if len(keys) else 0.0


def continuum_error(model: PolyModel, keys: np.ndarray, values: np.ndarray,
                    strict: bool = False) -> float:
    """Certificate extension for MAX soundness.

    The paper's LP (Eq. 10) bounds |F - P| at the keys only, but the MAX
    query (Eq. 17) maximizes P over a *continuous* region: a fit that
    interpolates the keys but bulges between them silently breaks Lemma 5.3.
    For query endpoints drawn from the key set, the region-max candidates
    are piece endpoints (covered by the key constraints) plus P's interior
    critical points, so err = max(key errors, |P(c) - m_i| for each
    critical point c inside piece i).  ``strict=True`` also certifies the
    right-limit of each flat piece (|P(k_{i+1}) - m_i|).
    """
    keys = np.asarray(keys, np.float64)
    values = np.asarray(values, np.float64)
    ell = len(keys)
    if ell == 0:
        return 0.0
    u = rescale(keys, model.lo, model.hi)
    Pu = eval_poly(model.coeffs, u)
    err = float(np.max(np.abs(values - Pu)))
    deg = model.deg
    if strict and ell >= 2:
        err = max(err, float(np.max(np.abs(Pu[1:] - values[:-1]))))
    if deg < 2 or ell < 2:
        return err
    dcoef = model.coeffs[1:] * np.arange(1, deg + 1)
    r = np.roots(dcoef[::-1]) if len(dcoef) > 1 else np.array([])
    crit = np.real(r[np.abs(np.imag(r)) < 1e-12]) if len(r) else np.array([])
    crit = crit[(crit > -1.0) & (crit < 1.0)]
    ua, ub = u[:-1], u[1:]
    for c in crit:
        inside = (ua < c) & (c < ub)
        if inside.any():
            pc = float(eval_poly(model.coeffs, np.float64(c)))
            err = max(err, float(np.max(np.abs(pc - values[:-1][inside]))))
    return err


# ---------------------------------------------------------------------------
# Least squares (screening)
# ---------------------------------------------------------------------------

def fit_lstsq(keys: np.ndarray, values: np.ndarray, deg: int) -> PolyModel:
    keys = np.asarray(keys, np.float64)
    values = np.asarray(values, np.float64)
    lo, hi = float(keys[0]), float(keys[-1])
    u = rescale(keys, lo, hi)
    A = _vander(u, deg)
    coef, *_ = np.linalg.lstsq(A, values, rcond=None)
    err = float(np.max(np.abs(values - A @ coef))) if len(keys) else 0.0
    return PolyModel(lo, hi, coef, err)


# ---------------------------------------------------------------------------
# Exact LP minimax (paper Eq. 10) — scipy/HiGHS
# ---------------------------------------------------------------------------

def fit_minimax_lp(keys: np.ndarray, values: np.ndarray, deg: int) -> PolyModel:
    """Solve Eq. 10 exactly: minimize t s.t. |F(k_i) - P(k_i)| <= t."""
    from scipy.optimize import linprog

    keys = np.asarray(keys, np.float64)
    values = np.asarray(values, np.float64)
    n = len(keys)
    lo, hi = float(keys[0]), float(keys[-1])
    if n <= deg + 1:
        # interpolation: error 0 (solve square/underdetermined system)
        u = rescale(keys, lo, hi)
        A = _vander(u, deg)
        coef, *_ = np.linalg.lstsq(A, values, rcond=None)
        err = float(np.max(np.abs(values - A @ coef))) if n else 0.0
        return PolyModel(lo, hi, coef, max(0.0, err))
    u = rescale(keys, lo, hi)
    A = _vander(u, deg)
    ones = np.ones((n, 1))
    #  F - A a <= t   ->  -A a - t <= -F
    #  A a - F <= t   ->   A a - t <=  F
    A_ub = np.block([[-A, -ones], [A, -ones]])
    b_ub = np.concatenate([-values, values])
    c = np.zeros(deg + 2)
    c[-1] = 1.0
    res = linprog(c, A_ub=A_ub, b_ub=b_ub,
                  bounds=[(None, None)] * (deg + 1) + [(0, None)],
                  method="highs")
    if not res.success:  # pragma: no cover - HiGHS is robust on these
        return fit_lstsq(keys, values, deg)
    coef = res.x[: deg + 1]
    err = float(np.max(np.abs(values - A @ coef)))
    return PolyModel(lo, hi, coef, err)


# ---------------------------------------------------------------------------
# Lawson IRLS minimax — torch, batched over candidate intervals
# ---------------------------------------------------------------------------

def _lawson_body(A, F, w, ridge):
    """One Lawson step on a batch: weighted lstsq, then reweight by
    |residual|.  A (B, L, d), F and w (B, L)."""
    Aw = A * w[..., None]
    AwT = Aw.transpose(-1, -2)
    G = AwT @ A + ridge * torch.eye(A.shape[-1], dtype=A.dtype,
                                    device=A.device)
    b = (AwT @ F[..., None])[..., 0]
    # solve_ex: no error check, so no host sync a step on the card (the
    # ridge keeps G nonsingular)
    coef = torch.linalg.solve_ex(G, b)[0]
    r = torch.abs(F - (A @ coef[..., None])[..., 0])
    w_new = w * r
    s = w_new.sum(dim=-1, keepdim=True)
    w_new = torch.where(s > 0, w_new / s, w)
    return coef, w_new, r


def lawson_batched(u, F, valid, deg: int, iters: int = 60):
    """Batched Lawson: u/F/valid are (B, L) padded windows in the scaled
    variable (``valid`` masks padding); returns coeffs (B, deg+1) and the
    max |residual| over each window's valid points (B,).

    The reference's ``jax.vmap`` of a ``lax.scan`` becomes one batched
    torch op per step on the tensors' device: the carry is (w, coef) and
    the residual is taken after the last step.
    """
    u = torch.as_tensor(u, dtype=DTYPE)
    F = torch.as_tensor(F, dtype=DTYPE, device=u.device)
    valid = torch.as_tensor(valid, dtype=DTYPE, device=u.device)
    A = torch.stack([u ** j for j in range(deg + 1)], dim=-1)
    # zero out padded rows so they contribute nothing
    A = A * valid[..., None]
    Fv = F * valid
    nval = torch.clamp(valid.sum(dim=-1, keepdim=True), min=1.0)
    w = valid / nval
    ridge = 1e-9
    coef = torch.zeros(u.shape[:-1] + (deg + 1,), dtype=DTYPE,
                       device=u.device)
    for _ in range(iters):
        coef, w, _ = _lawson_body(A, Fv, w, ridge)
    resid = torch.abs(Fv - (A @ coef[..., None])[..., 0]) * valid
    return coef, resid.max(dim=-1).values


def fit_minimax_lawson(keys, values, deg: int, iters: int = 60,
                       device=None) -> PolyModel:
    """Lawson minimax fit of one interval on ``device`` (the card by
    default); the certificate is the achieved max residual."""
    keys = np.asarray(keys, np.float64)
    values = np.asarray(values, np.float64)
    lo, hi = float(keys[0]), float(keys[-1])
    dev = resolve_device(device)
    u = torch.as_tensor(rescale(keys, lo, hi), device=dev)[None]
    F = torch.as_tensor(values, device=dev)[None]
    coef, err = lawson_batched(u, F, torch.ones_like(F), deg, iters)
    return PolyModel(lo, hi, coef[0].cpu().numpy(), float(err[0]))
