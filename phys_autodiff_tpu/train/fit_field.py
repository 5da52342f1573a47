"""Supervised neural-field fitting: compress grid snapshots into a model.

The north star frames this system as NGP-style, and Instant-NGP's
signature workload is fitting a compact neural field to DATA. The
reference has no data path at all — its MLP backward hard-codes an
MSE-vs-target head it never connects to real targets
(src/mlp_cuda.cu:123-184). This module closes that loop for every
registered model family (coordinate MLP, hash-NGP, Fourier, third-party
encoders via models/encoders): fit model parameters to one or more grid
snapshots with the reference's own weighted-MSE semantics, optionally
regularized by the physics-residual loss (the classic PINN composite
L = L_data + lambda * L_phys — data assimilation).

Together with utils/export and models/sample this completes the
round-trip: simulate (apps/euler) -> export snapshots -> fit a neural
field -> serve it at arbitrary continuous points / seed new rollouts
(apps/euler.initial_state_from_model), at a measured compression ratio
(`compression_stats`).

Loss semantics mirror the physics loss exactly (reference
src/phys_cpu.cpp:140-148): L = w_sigma * mean(dsigma^2)
+ w_u * mean(|du|^2), the u-term a mean over N cells of the
channel-SUMMED squared error (not a mean over 3N).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import jax
import jax.numpy as jnp
import optax

from phys_autodiff_tpu import ops
from phys_autodiff_tpu.models import sample
from phys_autodiff_tpu.models.mlp import init_params as mlp_init_params
from phys_autodiff_tpu.ops.stencil import FieldSnapshots
from phys_autodiff_tpu.train.loop import TrainConfig, make_optimizer
from phys_autodiff_tpu.utils.config import (
    GridSpec,
    MLPGridConfig,
    PhysWeights,
)


class FitTarget(NamedTuple):
    """One supervision snapshot: the fields the model should reproduce at
    time t. Layouts are the framework's standard [nz, ny, nx] scalar and
    [3, nz, ny, nx] channel-first vector."""

    sigma: jnp.ndarray
    u: jnp.ndarray
    t: float


def target_from_arrays(sigma, u, t: float) -> FitTarget:
    """FitTarget from host/NumPy arrays (e.g. utils.export.load_fields_npz
    output) — values are converted to f32 jnp arrays once, outside jit."""
    return FitTarget(
        jnp.asarray(sigma, jnp.float32), jnp.asarray(u, jnp.float32), float(t)
    )


def init_any(model_cfg, seed: int = 0):
    """Seeded parameter init for EITHER model family (the fit-side
    analogue of sample.grid_infer_any's dispatch)."""
    if isinstance(model_cfg, MLPGridConfig):
        return mlp_init_params(model_cfg.dims, seed=seed)
    from phys_autodiff_tpu.models import ngp as ngp_mod

    return ngp_mod.init_ngp_params(model_cfg, seed=seed)


def data_loss(
    g: GridSpec,
    model_cfg,
    params,
    target: FitTarget,
    w: PhysWeights = PhysWeights(),
) -> jnp.ndarray:
    """Weighted field MSE of the model output against one snapshot."""
    out = sample.grid_infer_any(g, model_cfg, params, target.t)
    ds = out[..., 0] - target.sigma
    du = jnp.moveaxis(out[..., 1:4], -1, 0) - target.u
    return jnp.float32(w.w_sigma) * jnp.mean(ds * ds) + jnp.float32(
        w.w_u
    ) * jnp.mean(jnp.sum(du * du, axis=0))


def snapshots_from_model(g: GridSpec, model_cfg, params, t) -> FieldSnapshots:
    """The six physics inputs (t-dt, t, t+dt) from ANY model family — the
    family-agnostic analogue of models.fields.generate_fields (reference
    src/mlp_grid.cpp:82-106). The MLP family dispatches to generate_fields
    itself (one batched 3-slice evaluation, bit-identical to the physics
    training path); encoded families evaluate per slice."""
    if isinstance(model_cfg, MLPGridConfig):
        from phys_autodiff_tpu.models import fields as fields_mod

        return fields_mod.generate_fields(g, model_cfg, params, t, g.dt)
    slices = []
    for tt in (t - g.dt, t, t + g.dt):
        out = sample.grid_infer_any(g, model_cfg, params, tt)
        slices.append((out[..., 0], jnp.moveaxis(out[..., 1:4], -1, 0)))
    (s_m, u_m), (s_0, u_0), (s_p, u_p) = slices
    return FieldSnapshots(s_m, s_0, s_p, u_m, u_0, u_p)


def make_fit_loss(
    g: GridSpec,
    model_cfg,
    targets: Sequence[FitTarget],
    w_data: PhysWeights = PhysWeights(),
    phys_weight: float = 0.0,
    w_phys: PhysWeights = PhysWeights(),
):
    """(params) -> scalar composite loss: the snapshot-mean data loss,
    plus phys_weight times the snapshot-mean physics-residual loss (the
    PINN composite; phys_weight=0 skips the residual chain entirely).

    `targets` is a static Python sequence — each snapshot's terms are
    traced into the one jitted program (snapshot count is a model choice,
    not data-dependent control flow)."""
    if not targets:
        raise ValueError("need at least one FitTarget")
    targets = list(targets)
    inv = 1.0 / len(targets)

    def loss_fn(params):
        total = jnp.float32(0.0)
        for tgt in targets:
            total = total + data_loss(g, model_cfg, params, tgt, w_data)
            if phys_weight:
                fs = snapshots_from_model(g, model_cfg, params, tgt.t)
                total = total + jnp.float32(phys_weight) * ops.total_loss(
                    g, w_phys, fs
                )
        return total * jnp.float32(inv)

    return loss_fn


def fit_field(
    g: GridSpec,
    model_cfg,
    targets: Sequence[FitTarget],
    cfg: TrainConfig = TrainConfig(),
    params0: Any | None = None,
    w_data: PhysWeights = PhysWeights(),
    phys_weight: float = 0.0,
    w_phys: PhysWeights = PhysWeights(),
):
    """Fit model_cfg's parameters to the target snapshots.

    Runs cfg.steps optimizer steps (cfg's optimizer/schedule/clip chain,
    train/loop.make_optimizer) as ONE on-device lax.scan. Returns
    (params, losses[cfg.steps])."""
    params = init_any(model_cfg, seed=cfg.seed) if params0 is None else params0
    loss_and_grad = jax.value_and_grad(
        make_fit_loss(g, model_cfg, targets, w_data, phys_weight, w_phys)
    )
    opt = make_optimizer(cfg)

    @jax.jit
    def run(params):
        def body(carry, _):
            params, opt_state = carry
            loss, grads = loss_and_grad(params)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), loss

        (params_f, _), losses = jax.lax.scan(
            body, (params, opt.init(params)), None, length=cfg.steps
        )
        return params_f, losses

    return run(params)


def make_sharded_fit_step(
    g: GridSpec,
    model_cfg,
    targets: Sequence[FitTarget],
    mesh,
    cfg: TrainConfig = TrainConfig(),
    w_data: PhysWeights = PhysWeights(),
    phys_weight: float = 0.0,
    w_phys: PhysWeights = PhysWeights(),
):
    """Multi-chip supervised fitting: params replicated, targets and the
    model's grid output z-sharded — the fit-side counterpart of
    parallel.sharded.make_generic_sharded_train_step, so data
    assimilation scales over the mesh exactly like physics training
    (GSPMD: the partitioner inserts the gradient all-reduce).

    Returns (step, init): step(params, opt_state) -> (params',
    opt_state', loss); init(params=None) places replicated params +
    optimizer state on the mesh. The targets are device_put z-sharded
    once, here."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from phys_autodiff_tpu.parallel.mesh import (
        Z_AXIS,
        field_shardings,
        replicated,
        scalar_spec,
        vector_spec,
    )

    rep = replicated(mesh)
    s_sh = NamedSharding(mesh, scalar_spec())
    v_sh = NamedSharding(mesh, vector_spec())
    out_sh = NamedSharding(mesh, P(Z_AXIS, None, None, None))
    targets = [
        FitTarget(
            jax.device_put(t.sigma, s_sh), jax.device_put(t.u, v_sh), t.t
        )
        for t in targets
    ]
    inv = 1.0 / len(targets)
    opt = make_optimizer(cfg)

    def loss_of(params):
        total = jnp.float32(0.0)
        for tgt in targets:
            out = sample.grid_infer_any(g, model_cfg, params, tgt.t)
            out = jax.lax.with_sharding_constraint(out, out_sh)
            ds = out[..., 0] - tgt.sigma
            du = jnp.moveaxis(out[..., 1:4], -1, 0) - tgt.u
            total = total + jnp.float32(w_data.w_sigma) * jnp.mean(ds * ds)
            total = total + jnp.float32(w_data.w_u) * jnp.mean(
                jnp.sum(du * du, axis=0)
            )
            if phys_weight:
                fs = snapshots_from_model(g, model_cfg, params, tgt.t)
                fs = jax.tree_util.tree_map(
                    jax.lax.with_sharding_constraint, fs, field_shardings(mesh)
                )
                total = total + jnp.float32(phys_weight) * ops.total_loss(
                    g, w_phys, fs
                )
        return total * jnp.float32(inv)

    @jax.jit
    def step(params, opt_state):
        loss, grads = jax.value_and_grad(loss_of)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    def init(params=None):
        if params is None:
            params = init_any(model_cfg, seed=cfg.seed)
        params = jax.device_put(params, rep)
        return params, jax.device_put(opt.init(params), rep)

    return step, init


def psnr(pred, ref) -> jnp.ndarray:
    """Peak signal-to-noise ratio (dB) with the reference's dynamic range
    as peak — the standard fit-quality scalar for neural-field compression
    (Instant-NGP reports image/field PSNR)."""
    pred = jnp.asarray(pred, jnp.float32)
    ref = jnp.asarray(ref, jnp.float32)
    mse = jnp.mean((pred - ref) ** 2)
    peak = jnp.max(ref) - jnp.min(ref)
    return 10.0 * jnp.log10(peak * peak / jnp.maximum(mse, 1e-30))


def fit_report(g: GridSpec, model_cfg, params, targets: Sequence[FitTarget]):
    """Per-snapshot PSNR (sigma and u) plus compression stats, as plain
    Python floats — the user-facing summary of a fit."""
    rows = []
    for tgt in targets:
        out = sample.grid_infer_any(g, model_cfg, params, tgt.t)
        rows.append(
            {
                "t": float(tgt.t),
                "psnr_sigma_db": float(psnr(out[..., 0], tgt.sigma)),
                "psnr_u_db": float(
                    psnr(jnp.moveaxis(out[..., 1:4], -1, 0), tgt.u)
                ),
            }
        )
    return {"snapshots": rows, **compression_stats(params, g, len(targets))}


def compression_stats(params, g: GridSpec, num_snapshots: int) -> dict:
    """Model bytes vs raw snapshot bytes (4 f32 channels per cell per
    snapshot). >1 compression means the neural field is smaller than the
    data it reproduces — and it additionally serves CONTINUOUS (x,y,z,t),
    which the raw grids cannot."""
    leaves = jax.tree_util.tree_leaves(params)
    param_bytes = int(sum(x.size * x.dtype.itemsize for x in leaves))
    raw_bytes = int(num_snapshots) * 4 * g.num_cells * 4
    return {
        "param_bytes": param_bytes,
        "raw_bytes": raw_bytes,
        "compression_ratio": raw_bytes / max(param_bytes, 1),
    }
