"""XLA-staged transport residuals — the framework's "non-fused" arm.

Plays the role of the reference's non-fused CUDA chain
(src/phys_cuda_nonfused.cu:51-158: k_dt -> k_grad_sigma -> k_grad_u ->
k_residuals) but is expressed as jnp stencil ops and left to XLA to fuse or
stage. Float32 arithmetic end to end, matching the reference's in-kernel
float math. Fully differentiable: `jax.grad` through this path yields the
true field adjoint (the stencil transpose) that the reference never
implemented (its backward stops at the residual-space VJP,
include/phys.h:54).

Layout: scalar fields [nz, ny, nx]; vector fields [3, nz, ny, nx]; x is the
fastest-varying axis (the reference's flat layout).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from phys_autodiff_tpu.utils.config import GridSpec


class FieldSnapshots(NamedTuple):
    """The six physics input fields at t-dt, t, t+dt
    (reference: include/phys.h:26-36)."""

    sigma_tm1: jnp.ndarray  # [nz, ny, nx]
    sigma_t: jnp.ndarray  # [nz, ny, nx]
    sigma_tp1: jnp.ndarray  # [nz, ny, nx]
    u_tm1: jnp.ndarray  # [3, nz, ny, nx]
    u_t: jnp.ndarray  # [3, nz, ny, nx]
    u_tp1: jnp.ndarray  # [3, nz, ny, nx]


def shift(f: jnp.ndarray, delta: int, axis: int, periodic: bool) -> jnp.ndarray:
    """f at index i+delta along `axis`, periodic wrap or edge clamp.

    Clamp semantics match the reference's clampi (src/phys_cpu.cpp:8-10):
    out-of-range neighbors read the edge plane, so the edge "central"
    difference degenerates to (f[1]-f[0])/(2h).
    """
    if periodic:
        return jnp.roll(f, -delta, axis=axis)
    n = f.shape[axis]
    if delta > 0:
        body = jnp.take(f, jnp.arange(delta, n), axis=axis)
        edge = jnp.take(f, jnp.arange(n - 1, n), axis=axis)
        reps = [1] * f.ndim
        reps[axis] = delta
        return jnp.concatenate([body, jnp.tile(edge, reps)], axis=axis)
    elif delta < 0:
        d = -delta
        body = jnp.take(f, jnp.arange(0, n - d), axis=axis)
        edge = jnp.take(f, jnp.arange(0, 1), axis=axis)
        reps = [1] * f.ndim
        reps[axis] = d
        return jnp.concatenate([jnp.tile(edge, reps), body], axis=axis)
    return f


def inv2h_f32(h: float) -> np.float32:
    """THE central-difference scale constant, 1/(2h), with the exact f32
    rounding the residual operator uses: np.float32(1.0/(2.0*f32(h))).

    Every operator in the framework that divides by 2h (residuals,
    diagnostics.divergence/curl, projection.grad, the shard-local spectral
    and Euler stencils) must build its constant HERE: a naively-computed
    f32(0.5/h) differs in the last ulp for non-power-of-two spacings (e.g.
    h=0.05: 10.0 vs 9.99999985), so e.g. a velocity projected to zero
    divergence under one constant would feed the residual's sigma*div_u a
    ~1e-8-relative offset under the other — breaking the 1e-7 doctrine's
    "the operators agree with themselves" premise."""
    return np.float32(1.0 / (2.0 * float(np.float32(h))))


def central_diff(
    f: jnp.ndarray, axis: int, inv2h: float, periodic: bool
) -> jnp.ndarray:
    """(f[i+1] - f[i-1]) * inv2h along `axis`."""
    return (shift(f, +1, axis, periodic) - shift(f, -1, axis, periodic)) * inv2h


def upwind_diff(
    f: jnp.ndarray, a: jnp.ndarray, axis: int, invh: float, periodic: bool
) -> jnp.ndarray:
    """First-order upwind derivative of f along `axis` advected by velocity
    a: backward difference where a > 0, forward otherwise (GridSpec.scheme
    == "upwind", the reference's planned M4 switch, REQUIREMENT.md:131-134).
    """
    bwd = (f - shift(f, -1, axis, periodic)) * invh
    fwd = (shift(f, +1, axis, periodic) - f) * invh
    return jnp.where(a > 0.0, bwd, fwd)


def _advection(g: GridSpec, s_t, u_t, grads_central):
    """Advection terms (adv_sigma, adv_u) under g.scheme.

    grads_central = (ds_dx, ds_dy, ds_dz, du_dx, du_dy, du_dz) from the
    central path (reused when scheme == "central")."""
    ux, uy, uz = u_t[0], u_t[1], u_t[2]
    if g.scheme != "upwind":
        ds_dx, ds_dy, ds_dz, du_dx, du_dy, du_dz = grads_central
        adv_sigma = ux * ds_dx + uy * ds_dy + uz * ds_dz
        adv_u = ux[None] * du_dx + uy[None] * du_dy + uz[None] * du_dz
        return adv_sigma, adv_u
    ndim = s_t.ndim
    ax_z, ax_y, ax_x = ndim - 3, ndim - 2, ndim - 1
    invhx = np.float32(1.0 / float(np.float32(g.hx)))
    invhy = np.float32(1.0 / float(np.float32(g.hy)))
    invhz = np.float32(1.0 / float(np.float32(g.hz)))
    per = g.periodic

    def adv(f):
        return (
            ux * upwind_diff(f, ux, ax_x, invhx, per)
            + uy * upwind_diff(f, uy, ax_y, invhy, per)
            + uz * upwind_diff(f, uz, ax_z, invhz, per)
        )

    adv_sigma = adv(s_t)
    adv_u = jnp.stack([adv(ux), adv(uy), adv(uz)])
    return adv_sigma, adv_u


def residuals(g: GridSpec, fields: FieldSnapshots):
    """Transport residuals (reference math: src/phys_cpu.cpp:66-106,
    REQUIREMENT.md:18-26):

        R_sigma = d sigma/dt + u . grad(sigma) + sigma * div(u)
        R_u     = d u/dt + (u . grad) u

    Returns (R_sigma [nz,ny,nx], R_u [3,nz,ny,nx]) in float32.
    """
    s_t = fields.sigma_t
    u_t = fields.u_t
    ndim = s_t.ndim
    ax_z, ax_y, ax_x = ndim - 3, ndim - 2, ndim - 1

    inv2dt = inv2h_f32(g.dt)
    inv2hx = inv2h_f32(g.hx)
    inv2hy = inv2h_f32(g.hy)
    inv2hz = inv2h_f32(g.hz)
    per = g.periodic

    dt_sigma = (fields.sigma_tp1 - fields.sigma_tm1) * inv2dt
    du_dt = (fields.u_tp1 - fields.u_tm1) * inv2dt

    ds_dx = central_diff(s_t, ax_x, inv2hx, per)
    ds_dy = central_diff(s_t, ax_y, inv2hy, per)
    ds_dz = central_diff(s_t, ax_z, inv2hz, per)

    # Gradient of every u channel along every axis: du[c, a] = d u_c / d a,
    # a in (x, y, z). Batched over the channel axis.
    du_dx = central_diff(u_t, ax_x + 1, inv2hx, per)
    du_dy = central_diff(u_t, ax_y + 1, inv2hy, per)
    du_dz = central_diff(u_t, ax_z + 1, inv2hz, per)

    div_u = du_dx[0] + du_dy[1] + du_dz[2]  # central in both schemes
    adv_sigma, adv_u = _advection(
        g, s_t, u_t, (ds_dx, ds_dy, ds_dz, du_dx, du_dy, du_dz)
    )

    r_sigma = dt_sigma + adv_sigma + s_t * div_u
    r_u = du_dt + adv_u
    return r_sigma, r_u


def residuals_zext(g: GridSpec, sigma, u):
    """Residuals of a z-extended slab: one halo row per side along z.

    sigma: [3, R, ny, nx] (time slices tm1/t/tp1, R = rows + 2 halo rows)
    u:     [3, 3, R, ny, nx] (slice, channel, ...)
    Returns (r_sigma [R-2, ny, nx], r_u [3, R-2, ny, nx]).

    The z derivative is the interior difference of the extended rows
    (ext[2:] - ext[:-2]); x/y keep the global wrap/clamp semantics (the slab
    spans the full x/y extents). This is the building block for slab-blocked
    recompute backward passes and the shard_map halo arm: the caller supplies
    halo rows that already encode the global z boundary (wrap, clamp, or a
    neighbor shard's plane).
    """
    inv2dt = inv2h_f32(g.dt)
    inv2hx = inv2h_f32(g.hx)
    inv2hy = inv2h_f32(g.hy)
    inv2hz = inv2h_f32(g.hz)
    per = g.periodic

    s_t = sigma[1, 1:-1]
    u_t = u[1][:, 1:-1]  # [3, R-2, ny, nx]
    dt_sigma = (sigma[2, 1:-1] - sigma[0, 1:-1]) * inv2dt
    du_dt = (u[2][:, 1:-1] - u[0][:, 1:-1]) * inv2dt

    ax_y, ax_x = 1, 2

    def ddz(ext):  # [..., R, ny, nx] -> interior
        return (ext[..., 2:, :, :] - ext[..., :-2, :, :]) * inv2hz

    ds_dx = central_diff(s_t, ax_x, inv2hx, per)
    ds_dy = central_diff(s_t, ax_y, inv2hy, per)
    ds_dz = ddz(sigma[1])
    du_dx = central_diff(u_t, ax_x + 1, inv2hx, per)
    du_dy = central_diff(u_t, ax_y + 1, inv2hy, per)
    du_dz = ddz(u[1])

    ux, uy, uz = u_t[0], u_t[1], u_t[2]
    div_u = du_dx[0] + du_dy[1] + du_dz[2]  # central in both schemes
    if g.scheme == "upwind":
        invhx = np.float32(1.0 / float(np.float32(g.hx)))
        invhy = np.float32(1.0 / float(np.float32(g.hy)))
        invhz = np.float32(1.0 / float(np.float32(g.hz)))

        def ddz_up(ext, a):  # one-sided z from the extended rows
            c = ext[..., 1:-1, :, :]
            bwd = (c - ext[..., :-2, :, :]) * invhz
            fwd = (ext[..., 2:, :, :] - c) * invhz
            return jnp.where(a > 0.0, bwd, fwd)

        def adv(f_c, f_ext):
            return (
                ux * upwind_diff(f_c, ux, ax_x, invhx, per)
                + uy * upwind_diff(f_c, uy, ax_y, invhy, per)
                + uz * ddz_up(f_ext, uz)
            )

        adv_sigma = adv(s_t, sigma[1])
        adv_u = jnp.stack(
            [adv(u_t[0], u[1][0]), adv(u_t[1], u[1][1]), adv(u_t[2], u[1][2])]
        )
    else:
        adv_sigma = ux * ds_dx + uy * ds_dy + uz * ds_dz
        adv_u = ux[None] * du_dx + uy[None] * du_dy + uz[None] * du_dz

    r_sigma = dt_sigma + adv_sigma + s_t * div_u
    r_u = du_dt + adv_u
    return r_sigma, r_u
