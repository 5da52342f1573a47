"""Weighted MSE physics loss: forward, hand-VJP backward, and f64 reduction.

Reference semantics (src/phys_cpu.cpp:112-170, include/phys.h:38-64):
    L_sigma = w_sigma * sum(R_sigma^2) / N
    L_u     = w_u * sum(R_ux^2 + R_uy^2 + R_uz^2) / N     (mean over N, not 3N)
    backward (w.r.t. residuals): g = (2 w / N) * R

Three reduction flavors:
  * `loss_forward` — on-device float32, jittable/differentiable (training).
  * `loss_forward_f64` — residuals on device, reduction on host in float64,
    mirroring how both reference arms reduce in double on the host
    (src/phys_cpu.cpp:140-148, src/phys_cuda_nonfused.cu:386-391). This is the
    arm held to the 1e-7 loss tolerance.
  * `loss_backward` — the reference-shaped residual-space VJP.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from phys_autodiff_tpu.ops.stencil import FieldSnapshots, residuals
from phys_autodiff_tpu.utils.config import GridSpec, PhysWeights


def loss_terms(g: GridSpec, w: PhysWeights, r_sigma, r_u):
    """(L_sigma, L_u) from residuals, float32 on-device reduction."""
    inv_n = jnp.float32(1.0 / g.num_cells)
    l_sigma = jnp.float32(w.w_sigma) * jnp.sum(r_sigma * r_sigma) * inv_n
    l_u = jnp.float32(w.w_u) * jnp.sum(r_u * r_u) * inv_n
    return l_sigma, l_u


def loss_forward(g: GridSpec, w: PhysWeights, fields: FieldSnapshots):
    """(L_sigma, L_u) — jittable, differentiable end to end."""
    r_sigma, r_u = residuals(g, fields)
    return loss_terms(g, w, r_sigma, r_u)


def total_loss(g: GridSpec, w: PhysWeights, fields: FieldSnapshots):
    """Scalar L = L_sigma + L_u, the training objective."""
    l_sigma, l_u = loss_forward(g, w, fields)
    return l_sigma + l_u


def loss_forward_f64(g: GridSpec, w: PhysWeights, fields: FieldSnapshots):
    """Device residuals + host float64 reduction (the 1e-7-tolerance arm)."""
    r_sigma, r_u = residuals(g, fields)
    n = float(g.num_cells)
    acc_sigma = np.sum(np.asarray(r_sigma, dtype=np.float64) ** 2)
    acc_u = np.sum(np.asarray(r_u, dtype=np.float64) ** 2)
    return np.float32(w.w_sigma * acc_sigma / n), np.float32(w.w_u * acc_u / n)


def plane_partials(r_sigma, r_u):
    """Per-z-plane raw partial sums [2, nz] of the residual squares.

    The deterministic-reduction building block of the sharded loss:
    per-plane sums are computed by identical local programs on any mesh,
    and the final combination is an explicit fixed-order chain
    (`sum_partials`), so sharded == single-chip at the 1e-7 doctrine
    instead of the 1e-4 of an order-free psum."""
    ps = jnp.sum(r_sigma * r_sigma, axis=(-2, -1))
    pu = jnp.sum(r_u * r_u, axis=(0, -2, -1))
    return jnp.stack([ps, pu])


def sum_partials(g: GridSpec, w: PhysWeights, parts):
    """Fixed-order sequential combination of [2, nz] per-plane partials into
    (L_sigma, L_u) — association independent of device count."""
    import functools

    nz = parts.shape[1]
    s = functools.reduce(lambda a, i: a + parts[0, i], range(nz), jnp.float32(0.0))
    u = functools.reduce(lambda a, i: a + parts[1, i], range(nz), jnp.float32(0.0))
    inv_n = jnp.float32(1.0 / g.num_cells)
    return jnp.float32(w.w_sigma) * s * inv_n, jnp.float32(w.w_u) * u * inv_n


def loss_forward_planewise(g: GridSpec, w: PhysWeights, fields: FieldSnapshots):
    """(L_sigma, L_u) with the deterministic plane-partial reduction."""
    r_sigma, r_u = residuals(g, fields)
    return sum_partials(g, w, plane_partials(r_sigma, r_u))


def loss_backward(g: GridSpec, w: PhysWeights, r_sigma, r_u):
    """Residual-space VJP g = (2 w / N) * R (include/phys.h:54), scales in
    float32 exactly as the reference computes them (src/phys_cpu.cpp:162-163).
    """
    n = jnp.float32(g.num_cells)
    scale_sigma = jnp.float32(2.0) * jnp.float32(w.w_sigma) / n
    scale_u = jnp.float32(2.0) * jnp.float32(w.w_u) / n
    return scale_sigma * r_sigma, scale_u * r_u
