"""Divergence-free-by-construction field models: u = curl A.

The second half of the reference plan's never-built "Divergence-Free
Velocity: optional projection or param via vector potential" item
(reference: docs/PLAN_MLP_SMOKE_INTEGRATION.md:51), made TRAINABLE: the
model's last three output channels are reinterpreted as a vector potential
A, and the velocity the physics sees is the discrete curl

    u = curl_h A        (ops.projection.velocity_from_potential)

which the framework's own divergence operator — the residual stencil's
central difference — annihilates IDENTICALLY, in BOTH boundary modes
(cross-axis shift operators commute even under clamp; see
ops/projection.py). Unlike the projection route there is no solve, no
iteration, and no attainable-range caveat: incompressibility is a
structural property of the parameterization, exact at initialization and
preserved by every optimizer step.

Works for every model family the framework trains (coordinate MLP and any
registered encoder family — the 4 output channels are just relabeled
[sigma, Ax, Ay, Az]), through the same generic training step. The physics
loss is unchanged: R_sigma's sigma*div(u) term vanishes exactly, R_u keeps
the full advective structure.

Serving: `eval_points_solenoidal` evaluates the CONTINUOUS curl at
arbitrary points via jax.jacfwd of the model w.r.t. the query coordinates
(chain rule through the unit-cube normalization), giving an analytically
solenoidal velocity field in the continuum sense — the grid route and the
point route agree to the stencil's O(h^2) truncation, and each is exactly
divergence-free under its OWN divergence notion (discrete / continuous).

Cost: the grid path adds six stencil shifts on top of grid inference
(pure rolls, fused by XLA); the point path evaluates the model under
jacfwd — 3 extra tangent passes, still batched matmuls, no gathers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from phys_autodiff_tpu.ops.projection import velocity_from_potential
from phys_autodiff_tpu.ops.stencil import FieldSnapshots
from phys_autodiff_tpu.utils.config import GridSpec


def grid_infer_solenoidal(g: GridSpec, model_cfg, params, t):
    """(sigma [nz, ny, nx], u [3, nz, ny, nx]) with u = discrete curl of
    the model's potential channels — `diagnostics.divergence(g, u)` is
    zero to rounding by construction. Grid inference is f32 for every
    family (the curl subtracts near-equal neighbors; a bf16 grid tier
    would surface as spurious divergence)."""
    from phys_autodiff_tpu.models.sample import grid_infer_any

    y = grid_infer_any(g, model_cfg, params, t)
    sigma = y[..., 0]
    pot = jnp.moveaxis(y[..., 1:4], -1, 0)
    return sigma, velocity_from_potential(g, pot)


def generate_fields_solenoidal(
    g: GridSpec, model_cfg, params, t, dt
) -> FieldSnapshots:
    """The six physics inputs at t-dt, t, t+dt with every velocity slice
    exactly divergence-free (drop-in for models.generate_fields)."""
    t = jnp.float32(t)
    dt = jnp.float32(dt)
    outs = [
        grid_infer_solenoidal(g, model_cfg, params, tt)
        for tt in (t - dt, t, t + dt)
    ]
    return FieldSnapshots(
        sigma_tm1=outs[0][0],
        sigma_t=outs[1][0],
        sigma_tp1=outs[2][0],
        u_tm1=outs[0][1],
        u_t=outs[1][1],
        u_tp1=outs[2][1],
    )


def make_solenoidal_train_step(
    g: GridSpec,
    w,
    model_cfg,
    cfg,
    params0,
):
    """(jitted_step, state0) training the solenoidal head against the
    physics loss — `train.make_generic_train_step` over
    `generate_fields_solenoidal` (any model family; gradients flow through
    the curl's six stencil shifts for free)."""
    from phys_autodiff_tpu.train.loop import make_generic_train_step

    return make_generic_train_step(
        g,
        w,
        lambda p, tt: generate_fields_solenoidal(
            g, model_cfg, p, tt, g.dt
        ),
        cfg,
        params0,
    )


def eval_points_solenoidal(
    g: GridSpec,
    model_cfg,
    params,
    pts_unit: jnp.ndarray,
    t,
    precision: str = "f32",
):
    """(sigma [N], u [N, 3]) at arbitrary unit-cube points: u is the
    CONTINUOUS curl of the potential channels, computed with jacfwd
    through the model w.r.t. the query coordinates.

    Physical derivative chain rule: unit coord u_a = x_a / ((n_a-1) h_a),
    so d/dx_a = (1/((n_a-1) h_a)) d/du_a. The result is analytically
    divergence-free (div curl = 0 holds for exact derivatives, and
    autodiff derivatives ARE exact derivatives of the network function).
    Differentiable in params; O(3x) the plain evaluation cost (one
    forward + 3 forward-mode tangents, all batched matmul work)."""
    from phys_autodiff_tpu.models.sample import evaluate_points

    pts_unit = jnp.asarray(pts_unit, jnp.float32)
    inv_h = jnp.asarray(
        [
            1.0 / (max(g.nx - 1, 1) * g.hx),
            1.0 / (max(g.ny - 1, 1) * g.hy),
            1.0 / (max(g.nz - 1, 1) * g.hz),
        ],
        jnp.float32,
    )

    def eval_batched(pu):  # [N, 3] -> [N, 4]
        return evaluate_points(model_cfg, params, pu, t, precision)

    # one forward-mode tangent pass per spatial axis, batched over ALL
    # points at once (each jvp is ~1 extra batched forward); the
    # primal comes from the first jvp for free — total cost is exactly
    # the docstring's one forward + 3 tangents. dA[a][:, c] = dA_c / dx_a
    y = None
    dA = []
    for a in range(3):
        tang = jnp.zeros_like(pts_unit).at[:, a].set(1.0)
        primal, jv = jax.jvp(eval_batched, (pts_unit,), (tang,))
        if y is None:
            y = primal
        dA.append(jv[:, 1:4] * inv_h[a])
    u = jnp.stack(
        [
            dA[1][:, 2] - dA[2][:, 1],  # dAz/dy - dAy/dz
            dA[2][:, 0] - dA[0][:, 2],  # dAx/dz - dAz/dx
            dA[0][:, 1] - dA[1][:, 0],  # dAy/dx - dAx/dy
        ],
        axis=-1,
    )
    return y[:, 0], u
