"""Divergence-free velocity projection — the reference's planned M6 item.

The reference's integration plan lists "Divergence-Free Velocity: optional
projection or param via vector potential for more realistic smoke velocity
fields" (reference: docs/PLAN_MLP_SMOKE_INTEGRATION.md:51) but never built
either. This module builds BOTH, discretely consistent with the framework's
own stencil: "divergence-free" here means `ops.diagnostics.divergence`
(the residual operator's central-difference div, src/phys_cpu.cpp:96-101)
returns ~0, not merely the continuum statement.

Three surfaces:

  * `project_fft(g, u)` — periodic boxes. Helmholtz projection solved in
    one shot via FFT with the EXACT symbol of the wide central difference:
    D_a e^{i k a} = i sin(k h_a)/h_a, so the discrete Poisson solve
    lap p = div u uses lap(k) = -sum_a sin^2(k_a h_a)/h_a^2 and the
    projected field's discrete divergence is zero to float rounding at
    every Fourier mode (modes where lap(k)=0 have div(k)=0 identically,
    since each sin factor is then 0). Three rfftn/irfftn pairs
    and elementwise work — all XLA-native, no iteration, no gathers.
  * `project_cg(g, u, ...)` — clamp (non-periodic) boxes, where no fast
    diagonalization of the clamped wide stencil exists: iterative
    least-squares solve of div(grad p) = div u with the boundary-exact
    stencil operators (CGNR — CG on the normal equations, A^T from
    jax.linear_transpose; the clamped operator itself is nonsymmetric
    and BiCGStab on it measurably diverges for rough RHS). Converges to
    the achievable component; tests pin a large divergence reduction,
    not exactness.
  * `velocity_from_potential(g, A)` — u = curl A. Shift operators along
    DIFFERENT axes commute in both boundary modes (clamping x does not
    disturb y-shifts), so div(curl A) cancels identically: an EXACTLY
    divergence-free parameterization even on clamp grids, at the cost of
    representing u indirectly. This is the "param via vector potential"
    half of the reference's sentence.

All paths are pure jnp on the framework layouts (u channel-major
[3, nz, ny, nx], x fastest), fully differentiable, and fuse under jit.

Null-space note (wide stencil): the central difference annihilates the
Nyquist mode per axis, so components of u invisible to the discrete div
(e.g. checkerboards) pass through the projector unchanged — by design:
the projector removes exactly what the residual operator can see.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from phys_autodiff_tpu.ops.diagnostics import curl, divergence
from phys_autodiff_tpu.ops.stencil import central_diff, inv2h_f32
from phys_autodiff_tpu.utils.config import GridSpec

_AX_Z, _AX_Y, _AX_X = 0, 1, 2


def grad(g: GridSpec, p: jnp.ndarray) -> jnp.ndarray:
    """Central-difference gradient of a scalar: [3, nz, ny, nx]
    (same arithmetic as the residual stencil's grad sigma)."""
    per = g.periodic
    return jnp.stack(
        [
            central_diff(p, _AX_X, inv2h_f32(g.hx), per),
            central_diff(p, _AX_Y, inv2h_f32(g.hy), per),
            central_diff(p, _AX_Z, inv2h_f32(g.hz), per),
        ]
    )


def _central_symbols(g: GridSpec):
    """sin-symbols of the wide central difference per axis, broadcastable
    over the rfftn spectrum of a [nz, ny, nx] field (x axis halved)."""
    # integer frequencies; sin(2 pi k / n) / h is D_a's eigenvalue magnitude.
    # sin must be EXACTLY zero at k = 0 and the Nyquist k = n/2 (floating
    # sin(pi) ~ 1e-16 would otherwise leak a ~1e32-amplified checkerboard
    # into p and destroy the solve in f32), so mask on 2k % n == 0.
    def s_of(k, n, h):
        k = np.rint(k).astype(np.int64)
        s = np.sin(2.0 * np.pi * k / n) / h
        return np.where((2 * k) % n == 0, 0.0, s)

    sz = s_of(np.fft.fftfreq(g.nz) * g.nz, g.nz, g.hz)
    sy = s_of(np.fft.fftfreq(g.ny) * g.ny, g.ny, g.hy)
    sx = s_of(np.fft.rfftfreq(g.nx) * g.nx, g.nx, g.hx)
    sz = jnp.asarray(sz.astype(np.float32))[:, None, None]
    sy = jnp.asarray(sy.astype(np.float32))[None, :, None]
    sx = jnp.asarray(sx.astype(np.float32))[None, None, :]
    return sz, sy, sx


def project_fft(g: GridSpec, u: jnp.ndarray) -> jnp.ndarray:
    """Exact discrete Helmholtz projection on a periodic grid.

    Returns u - grad p with lap p = div u solved spectrally under the wide
    central-difference symbol; `diagnostics.divergence` of the result is
    zero to float rounding. Idempotent; leaves curl-potential fields
    untouched. Differentiable (FFTs are linear).
    """
    assert g.periodic, "project_fft requires periodic boundaries; use project_cg"
    assert u.shape == (3,) + g.shape, (u.shape, g.shape)
    d = divergence(g, u)
    d_hat = jnp.fft.rfftn(d, axes=(0, 1, 2))
    sz, sy, sx = _central_symbols(g)
    lap = -(sx * sx + sy * sy + sz * sz)  # symbol of div(grad .)
    p_hat = jnp.where(lap != 0.0, d_hat / jnp.where(lap != 0.0, lap, 1.0), 0.0)
    p = jnp.fft.irfftn(p_hat, s=g.shape, axes=(0, 1, 2)).astype(u.dtype)
    return u - grad(g, p)


def _div_grad(g: GridSpec, p: jnp.ndarray) -> jnp.ndarray:
    """The discrete Poisson operator div(grad p) with the framework's
    boundary-exact stencils (the operator the projection must invert)."""
    return divergence(g, grad(g, p))


def project_cg(
    g: GridSpec,
    u: jnp.ndarray,
    *,
    maxiter: int = 200,
    tol: float = 1e-6,
) -> jnp.ndarray:
    """Iterative Helmholtz projection for clamp (or periodic) boundaries.

    Solves div(grad p) = div u in the least-squares sense via CGNR —
    conjugate gradients on the normal equations A^T A p = A^T d, with
    A = div(grad .) built from the exact clamped stencils and A^T from
    jax.linear_transpose. The clamped wide Laplacian is nonsymmetric at
    edges (plain CG can stall) and near-singular on the checkerboard
    sublattices (BiCGStab measurably DIVERGES on rough right-hand sides,
    e.g. post-advection velocities); the normal equations are symmetric
    PSD, so the residual decreases monotonically for any RHS. Reduces the
    discrete divergence to the operator's attainable range — not exact
    like the FFT path; pair with `velocity_from_potential` when exactness
    under clamp is required.

    Preconditioning note (measured NEGATIVE, 2026-08-19): wrapping this CG
    with the periodic spectral inverse of the normal operator (M(k) =
    1/(lap(k)^2 + delta)) was tried and rejected. On rough RHS it is
    actively harmful at any delta (1.4-5.6x worse divergence at equal
    iterations vs plain CGNR's 1.34/1.11 at 30/60 iters) because the
    rough RHS concentrates near the wide stencil's null modes, exactly
    where the clamp perturbation dominates the periodic symbol; on smooth
    RHS the best heavily-regularized setting (delta = 0.1*max lap^2) buys
    only ~1.8-2.7x fewer-iteration-equivalent while adding two FFT pairs
    per iteration — a net loss. Full sweep in docs/DESIGN.md ("Negative
    results").
    """
    assert u.shape == (3,) + g.shape, (u.shape, g.shape)
    d = divergence(g, u)
    d = d - jnp.mean(d)
    fwd = functools.partial(_div_grad, g)
    transpose = jax.linear_transpose(fwd, d)

    def normal_op(p):
        (atap,) = transpose(fwd(p))
        return atap

    (rhs,) = transpose(d)
    p, _ = jax.scipy.sparse.linalg.cg(normal_op, rhs, tol=tol, maxiter=maxiter)
    return u - grad(g, p)


def project(
    g: GridSpec,
    u: jnp.ndarray,
    *,
    maxiter: int = 200,
    tol: float = 1e-6,
) -> jnp.ndarray:
    """Boundary-aware dispatch: FFT (exact, one-shot) on periodic grids,
    CGNR on clamp grids."""
    if g.periodic:
        return project_fft(g, u)
    return project_cg(g, u, maxiter=maxiter, tol=tol)


def velocity_from_potential(g: GridSpec, A: jnp.ndarray) -> jnp.ndarray:
    """u = curl A — identically divergence-free in BOTH boundary modes.

    div(curl A) telescopes to (D_x D_y - D_y D_x) A_z + ... = 0 because
    shift operators along different axes commute (also under clamp).
    A: [3, nz, ny, nx] -> u: [3, nz, ny, nx]. Use as a model output head
    when hard incompressibility is required (the reference plan's
    "param via vector potential")."""
    assert A.shape == (3,) + g.shape, (A.shape, g.shape)
    return curl(g, A)


def projection_residual(g: GridSpec, u: jnp.ndarray) -> jnp.ndarray:
    """max |div u| — the scalar a projection is meant to drive to zero
    (jit-safe; convenience for tests/monitoring)."""
    return jnp.max(jnp.abs(divergence(g, u)))
