"""Score-aware (anisotropic) product quantization, the port of
vearch_tpu/ops/scann.py (the ScaNN technique of Guo et al. 2020).

For inner-product search, quantization error parallel to a datapoint
costs more than error orthogonal to it, so codebooks minimise

    l(x, x~) = h_par ||P_x (x - x~)||^2 + h_orth ||(I - P_x)(x - x~)||^2

with eta = h_par / h_orth = (d - 1) T^2 / (1 - T^2) from the
noise-shaping threshold T (`ns_threshold`, default 0.2).

Training is block coordinate descent over subspaces. The parallel term
mixes all subspaces; it is carried as two running values per row,
S = ||x - x~||^2 and a = (x - x~) . u, so each subspace step is one
[rows, ksub] product pair, and the codeword update is a batched
[dsub, dsub] solve per codeword. The reference's `lax.fori_loop` /
`lax.map` become Python loops over passes and subspaces of batched torch
ops; the assignment of each row depends on that row alone, so it runs
ASSIGN_CHUNK rows at a time, which bounds the [rows, ksub] terms (there
is no loop over rows). Subspaces update one after another, as in the
reference, so the [n, dsub, dsub] outer products exist for one subspace
at a time.

Given the same codebooks, `encode_anisotropic` gives the reference's
codes up to f32 summation order (the products are f32 with TF32 off).
"""

from __future__ import annotations

import numpy as np
import torch

from vearch_tpu_torch.ops import pq as pq_ops

ASSIGN_CHUNK = 65536  # rows per coordinate-descent chunk


def eta_from_threshold(t: float, d: int) -> float:
    """Anisotropic weight ratio h_par / h_orth from the noise-shaping
    threshold T."""
    t = float(t)
    if t <= 0.0:
        return 1.0  # plain reconstruction MSE
    t = min(t, 0.999)
    return (d - 1) * t * t / (1.0 - t * t)


def _split(x: torch.Tensor, m: int) -> torch.Tensor:
    n, d = x.shape
    return x.reshape(n, m, d // m)


def _coef(eta: float) -> float:
    """eta - 1 rounded as the reference computes it (f32 eta minus 1)."""
    return float(np.float32(eta) - np.float32(1.0))


def _decode(codebooks: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """[n, m] codes -> [n, m, dsub] codewords."""
    m = codebooks.shape[0]
    return codebooks[torch.arange(m, device=codes.device)[None, :], codes]


def _assign_anisotropic(
    xs: torch.Tensor,         # [n, m, dsub] residual subvectors
    us: torch.Tensor,         # [n, m, dsub] unit-direction subvectors
    codebooks: torch.Tensor,  # [m, ksub, dsub]
    codes0: torch.Tensor,     # [n, m] int64 warm start
    eta: float,
    passes: int = 1,
) -> torch.Tensor:
    """Coordinate-descent assignment under the anisotropic loss: with the
    other subspaces fixed, candidate c of subspace j costs
        (S_out + ||x_j - c||^2) + (eta - 1) (a_out + (x_j - c).u_j)^2
    (h_orth = 1), S_out / a_out kept incrementally. Returns [n, m]
    int64 codes."""
    c_sq = torch.sum(codebooks * codebooks, dim=-1)  # [m, ksub]
    out = torch.empty_like(codes0)
    for lo in range(0, xs.shape[0], ASSIGN_CHUNK):
        hi = min(lo + ASSIGN_CHUNK, xs.shape[0])
        out[lo:hi] = _assign_chunk(xs[lo:hi], us[lo:hi], codebooks, c_sq,
                                   codes0[lo:hi], _coef(eta), passes)
    return out


def _assign_chunk(xs, us, codebooks, c_sq, codes, coef, passes):
    m = xs.shape[1]
    codes = codes.clone()
    r = xs - _decode(codebooks, codes)
    s_j = torch.sum(r * r, dim=-1)   # [n, m]
    a_j = torch.sum(r * us, dim=-1)  # [n, m]
    for _ in range(passes):
        s_tot = torch.sum(s_j, dim=1)
        a_tot = torch.sum(a_j, dim=1)
        for j in range(m):
            s_out = s_tot - s_j[:, j]
            a_out = a_tot - a_j[:, j]
            xj, uj, cj = xs[:, j], us[:, j], codebooks[j]
            # ||x_j - c||^2 and (x_j - c).u_j for every candidate
            x_sq = torch.sum(xj * xj, dim=-1)
            cand_sq = x_sq[:, None] - 2.0 * (xj @ cj.T) + c_sq[j][None, :]
            xu = torch.sum(xj * uj, dim=-1)
            cand_dot = xu[:, None] - uj @ cj.T
            par = a_out[:, None] + cand_dot
            loss = (s_out[:, None] + cand_sq) + coef * par * par
            best = torch.argmin(loss, dim=1)  # first index on ties
            new_sq = torch.gather(cand_sq, 1, best[:, None])[:, 0]
            new_dot = torch.gather(cand_dot, 1, best[:, None])[:, 0]
            s_tot = s_out + new_sq
            a_tot = a_out + new_dot
            codes[:, j] = best
            s_j[:, j] = new_sq
            a_j[:, j] = new_dot
    return codes


def _update_codebooks(
    xs: torch.Tensor,         # [n, m, dsub]
    us: torch.Tensor,         # [n, m, dsub]
    codebooks: torch.Tensor,  # [m, ksub, dsub]
    codes: torch.Tensor,      # [n, m] int64
    eta: float,
) -> torch.Tensor:
    """Closed-form codeword update with the assignments fixed: per
    (subspace, codeword)
        [n_c I + (eta-1) sum u u^T] c = sum x + (eta-1) sum (a_out + x.u) u,
    a batched [dsub, dsub] solve, regularised by 1e-6 I; a codeword no row
    chose keeps its old value."""
    n, m, dsub = xs.shape
    ksub = codebooks.shape[1]
    coef = _coef(eta)
    r = xs - _decode(codebooks, codes)
    a_j = torch.sum(r * us, dim=-1)  # [n, m]
    a_out = torch.sum(a_j, dim=1, keepdim=True) - a_j
    eye = torch.eye(dsub, dtype=torch.float32, device=xs.device)
    new = torch.empty_like(codebooks)
    for j in range(m):
        cj, xj, uj = codes[:, j], xs[:, j], us[:, j]
        counts = torch.bincount(cj, minlength=ksub).float()
        sum_x = torch.zeros((ksub, dsub), device=xs.device).index_add_(
            0, cj, xj)
        sum_uu = torch.zeros((ksub, dsub, dsub), device=xs.device
                             ).index_add_(0, cj, uj[:, :, None] * uj[:, None, :])
        w = a_out[:, j] + torch.sum(xj * uj, dim=-1)
        sum_wu = torch.zeros((ksub, dsub), device=xs.device).index_add_(
            0, cj, w[:, None] * uj)
        lhs = counts[:, None, None] * eye[None] + coef * sum_uu
        lhs = lhs + 1e-6 * eye[None]
        rhs = sum_x + coef * sum_wu
        sol = torch.linalg.solve(lhs, rhs[:, :, None])[:, :, 0]
        new[j] = torch.where(counts[:, None] > 0, sol, codebooks[j])
    return new


def train_anisotropic_pq(
    x: torch.Tensor,  # [n, d] residuals to quantize
    u: torch.Tensor,  # [n, d] unit directions of the original rows
    m: int,
    ksub: int = 256,
    eta: float = 5.29,
    iters: int = 8,
    init_iters: int = 4,
    seed: int = 0,
) -> torch.Tensor:
    """Anisotropic codebooks [m, ksub, dsub]: plain (MSE) PQ as the warm
    start (`pq.train_pq`, seeded), then `iters` rounds of the
    coordinate-descent assignment and the closed-form update."""
    x, u = x.float(), u.float()
    codebooks = pq_ops.train_pq(x, m=m, ksub=ksub, iters=init_iters,
                                seed=seed)
    xs, us = _split(x, m), _split(u, m)
    codes = pq_ops.encode_pq(x, codebooks).long()
    for _ in range(iters):
        codes = _assign_anisotropic(xs, us, codebooks, codes, eta, passes=1)
        codebooks = _update_codebooks(xs, us, codebooks, codes, eta)
    return codebooks


def encode_anisotropic(
    x: torch.Tensor,          # [n, d] residuals
    u: torch.Tensor,          # [n, d] unit directions of the original rows
    codebooks: torch.Tensor,
    eta: float,
    passes: int = 2,
) -> torch.Tensor:
    """Codes [n, m] uint8 under the anisotropic loss: the nearest-codeword
    warm start, then `passes` coordinate refinements."""
    x = x.float()
    m = codebooks.shape[0]
    codes = pq_ops.encode_pq(x, codebooks).long()
    codes = _assign_anisotropic(_split(x, m), _split(u.float(), m),
                                codebooks, codes, eta, passes=passes)
    return codes.to(torch.uint8)


def anisotropic_loss(x, u, x_dec, eta: float) -> float:
    """Mean score-aware loss (h_orth = 1), in float64 on the host."""
    x = np.asarray(x, np.float64)
    u = np.asarray(u, np.float64)
    r = x - np.asarray(x_dec, np.float64)
    par = np.sum(r * u, axis=-1)
    tot = np.sum(r * r, axis=-1)
    return float(np.mean(tot + (eta - 1.0) * par * par))
