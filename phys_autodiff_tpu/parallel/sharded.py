"""Multi-chip execution paths.

Two arms, mirroring the single-chip staged/fused split:

  * GSPMD path (`residuals_sharded`, `make_sharded_train_step`): jit with
    NamedSharding constraints over the staged ops. XLA's partitioner turns
    the z-axis jnp.roll stencils into collective-permutes (NCCL on a GPU
    mesh) and the loss mean into a psum — the idiomatic "annotate and let
    XLA insert collectives" recipe. Fully differentiable, so the sharded
    training step is just value_and_grad of the sharded loss
    (weight-gradient all-reduce falls out of the partitioner).

  * shard_map path (`residuals_halo_sharded`, `loss_forward_halo_sharded`,
    `make_sharded_fused_train_step`): explicit spatial domain
    decomposition — each device works on its local z-slab extended by halo
    planes (exchanged with lax.ppermute, or recomputed from the replicated
    model in the fused step), the multi-GPU stencil halo exchange.

Both are validated against the single-device results by tests/test_sharding
on a CPU mesh (the standard JAX way to test multi-chip without a cluster).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from phys_autodiff_tpu import ops
from phys_autodiff_tpu.models import fields as fields_mod
from phys_autodiff_tpu.ops.loss import plane_partials, sum_partials
from phys_autodiff_tpu.ops.stencil import FieldSnapshots, residuals_zext
from phys_autodiff_tpu.parallel.mesh import (
    Z_AXIS,
    field_shardings,
    replicated,
    scalar_spec,
    vector_spec,
)
from phys_autodiff_tpu.utils.config import GridSpec, MLPGridConfig, PhysWeights


# ---------------------------------------------------------------------------
# GSPMD arm
# ---------------------------------------------------------------------------


def residuals_sharded(g: GridSpec, mesh, fields: FieldSnapshots):
    """Staged residuals under z-sharding constraints. XLA inserts the halo
    collectives for the rolled z-stencil."""
    s = NamedSharding(mesh, scalar_spec())
    v = NamedSharding(mesh, vector_spec())
    fields = FieldSnapshots(
        sigma_tm1=jax.lax.with_sharding_constraint(fields.sigma_tm1, s),
        sigma_t=jax.lax.with_sharding_constraint(fields.sigma_t, s),
        sigma_tp1=jax.lax.with_sharding_constraint(fields.sigma_tp1, s),
        u_tm1=jax.lax.with_sharding_constraint(fields.u_tm1, v),
        u_t=jax.lax.with_sharding_constraint(fields.u_t, v),
        u_tp1=jax.lax.with_sharding_constraint(fields.u_tp1, v),
    )
    return ops.residuals(g, fields)


def make_sharded_train_step(
    g: GridSpec,
    w: PhysWeights,
    mcfg: MLPGridConfig,
    mesh,
    learning_rate: float = 1e-3,
):
    """Jitted sharded training step: params replicated, fields z-sharded,
    loss psum'd, gradient all-reduce inserted by the partitioner.

    Returns (step_fn, init_fn): step(params, opt_state, t) ->
    (params', opt_state', loss).
    """
    import optax

    opt = optax.adam(learning_rate)
    rep = replicated(mesh)

    def loss_of(params, t):
        fs = fields_mod.generate_fields(g, mcfg, params, t, g.dt)
        fs = jax.tree_util.tree_map(
            jax.lax.with_sharding_constraint, fs, field_shardings(mesh)
        )
        return ops.total_loss(g, w, fs)

    @partial(
        jax.jit,
        in_shardings=(rep, rep, rep),
        out_shardings=(rep, rep, rep),
    )
    def step(params, opt_state, t):
        loss, grads = jax.value_and_grad(loss_of)(params, t)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    def init(params):
        params = jax.device_put(params, rep)
        return params, jax.device_put(opt.init(params), rep)

    return step, init


# ---------------------------------------------------------------------------
# shard_map + explicit halo arm (keeps the fused Pallas kernel on the mesh)
# ---------------------------------------------------------------------------


def _halo_extend_z(f, periodic: bool, axis: int = 0):
    """Extend a local z-slab with one halo plane per side via ppermute.

    f: local [nz_local, ny, nx] (or [3, nz_local, ...] with axis=1).
    For non-periodic grids the global edge shards duplicate their own edge
    plane (clamp semantics, src/phys_cpu.cpp:8-10).
    """
    n = jax.lax.psum(1, Z_AXIS)
    idx = jax.lax.axis_index(Z_AXIS)

    top = jax.lax.index_in_dim(f, f.shape[axis] - 1, axis=axis, keepdims=True)
    bot = jax.lax.index_in_dim(f, 0, axis=axis, keepdims=True)

    # halo from the previous shard (its top plane becomes our lower halo)
    fwd = [(i, (i + 1) % n) for i in range(n)]
    lower = jax.lax.ppermute(top, Z_AXIS, fwd)
    # halo from the next shard (its bottom plane becomes our upper halo)
    bwd = [(i, (i - 1) % n) for i in range(n)]
    upper = jax.lax.ppermute(bot, Z_AXIS, bwd)

    if not periodic:
        lower = jnp.where(idx == 0, bot, lower)  # clamp at global z=0
        upper = jnp.where(idx == n - 1, top, upper)  # clamp at global z=max
    return jnp.concatenate([lower, f, upper], axis=axis)


def _local_grid(g: GridSpec, nz_local: int) -> GridSpec:
    """The per-shard GridSpec for a halo-extended z-slab: identical to the
    global grid (INCLUDING the advection scheme and boundary mode) except
    for nz. The kept rows ext[1:-1] only ever read ext[0:-2] and ext[2:],
    so the z boundary mode never triggers for them — x/y keep the global
    wrap/clamp behavior, and z neighbors come from the halos."""
    import dataclasses

    return dataclasses.replace(g, nz=nz_local + 2)


def _halo_extend_fields(fs_local: FieldSnapshots, periodic: bool) -> FieldSnapshots:
    """Extend every local field slab with one exchanged halo plane per side."""
    return FieldSnapshots(
        sigma_tm1=_halo_extend_z(fs_local.sigma_tm1, periodic),
        sigma_t=_halo_extend_z(fs_local.sigma_t, periodic),
        sigma_tp1=_halo_extend_z(fs_local.sigma_tp1, periodic),
        u_tm1=_halo_extend_z(fs_local.u_tm1, periodic, axis=1),
        u_t=_halo_extend_z(fs_local.u_t, periodic, axis=1),
        u_tp1=_halo_extend_z(fs_local.u_tp1, periodic, axis=1),
    )


def _halo_map(local, mesh, out_specs):
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(FieldSnapshots(
            sigma_tm1=scalar_spec(), sigma_t=scalar_spec(), sigma_tp1=scalar_spec(),
            u_tm1=vector_spec(), u_t=vector_spec(), u_tp1=vector_spec(),
        ),),
        out_specs=out_specs,
        check_vma=False,  # the gathered loss partials are replicated by
        # construction (all_gather), which the checker cannot infer
    )


def residuals_halo_sharded(g: GridSpec, mesh, fields: FieldSnapshots):
    """Residuals under explicit z-domain decomposition.

    Each device extends its local slab with exchanged halo planes, runs the
    single-chip residual op on the extended slab (the halos make the local z
    edges produce exactly the interior/wrap global stencil) and drops the
    halo rows of the result.
    """
    n_shards = mesh.shape[Z_AXIS]  # NOT devices.size: multi-axis meshes
    assert g.nz % n_shards == 0, (
        f"nz={g.nz} must divide evenly over the {n_shards}-way '{Z_AXIS}' axis"
    )
    g_local = _local_grid(g, g.nz // n_shards)

    def local(fs_local: FieldSnapshots):
        ext = _halo_extend_fields(fs_local, g.periodic)
        rs, ru = ops.residuals(g_local, ext)
        return rs[1:-1], ru[:, 1:-1]

    return _halo_map(local, mesh, (scalar_spec(), vector_spec()))(fields)


def loss_forward_halo_sharded(
    g: GridSpec, w: PhysWeights, mesh, fields: FieldSnapshots
):
    """Loss forward on the mesh: ppermute halo exchange, per-shard raw
    per-plane partial sums, then a FIXED-ORDER reduction of the gathered
    [2, nz] partials.

    Determinism/parity: each z-plane's partial is computed by the same
    program as on a single chip (ops.loss.loss_forward_planewise), and the
    final sum is an explicit sequential chain over planes in global z order
    — identical association on any mesh size, so the sharded loss meets the
    single-chip loss at the 1e-7 doctrine rather than the 1e-4 of an
    unconstrained psum. Returns (L_sigma, L_u).
    """
    n_shards = mesh.shape[Z_AXIS]
    assert g.nz % n_shards == 0
    g_local = _local_grid(g, g.nz // n_shards)

    def local(fs_local: FieldSnapshots):
        ext = _halo_extend_fields(fs_local, g.periodic)
        rs, ru = ops.residuals(g_local, ext)
        parts = plane_partials(rs[1:-1], ru[:, 1:-1])  # [2, nz_local]
        return jax.lax.all_gather(parts, Z_AXIS, axis=1, tiled=True)

    gathered = _halo_map(local, mesh, P())(fields)
    return sum_partials(g, w, gathered)


def make_sharded_fused_train_step(
    g: GridSpec,
    w: PhysWeights,
    mcfg: MLPGridConfig,
    mesh,
    learning_rate: float = 1e-3,
    precision: str = "f32",
):
    """The sharded FUSED training step: z rows are partitioned contiguously
    over the mesh's z axis and each device generates its rows plus one
    recomputed halo row per side with the kernel pair (pallas/fieldgen.py,
    from the replicated params — cheaper than exchanging 12 planes), so
    nothing of size [N, H] exists on any device. Per-device gradients are
    psum'd; the loss is combined from all-gathered per-plane partials in
    a fixed order (the association of ops.loss.loss_forward_planewise).

    Returns (step_fn, init_fn): step(params, opt_state, t) ->
    (params', opt_state', loss).
    """
    import optax

    from phys_autodiff_tpu.pallas import fieldgen

    opt = optax.adam(learning_rate)
    rep = NamedSharding(mesh, P())
    n_shards = mesh.shape[Z_AXIS]
    assert g.nz % n_shards == 0, (
        f"nz={g.nz} must divide evenly over the {n_shards}-way '{Z_AXIS}' axis"
    )
    nz_local = g.nz // n_shards
    inv_n = np.float32(1.0 / g.num_cells)
    ct = np.asarray([[w.w_sigma], [w.w_u]], np.float32) * inv_n  # dL/dparts

    def local_loss_and_grad(params, t):
        me = jax.lax.axis_index(Z_AXIS)
        rows = me * nz_local - 1 + jnp.arange(nz_local + 2)
        rows = jnp.mod(rows, g.nz) if g.periodic else jnp.clip(rows, 0, g.nz - 1)

        def local_parts(p):
            fs = fieldgen.generate_fields(g, mcfg, p, t, g.dt, precision, rows)
            rs, ru = residuals_zext(
                g,
                jnp.stack([fs.sigma_tm1, fs.sigma_t, fs.sigma_tp1]),
                jnp.stack([fs.u_tm1, fs.u_t, fs.u_tp1]),
            )
            return plane_partials(rs, ru)  # [2, nz_local]

        parts, vjp = jax.vjp(local_parts, params)
        (grads,) = vjp(jnp.broadcast_to(ct, parts.shape))
        l_sigma, l_u = sum_partials(
            g, w, jax.lax.all_gather(parts, Z_AXIS, axis=1, tiled=True)
        )
        return l_sigma + l_u, jax.lax.psum(grads, Z_AXIS)

    loss_and_grad = jax.shard_map(
        local_loss_and_grad,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=(P(), P()),
        check_vma=False,  # pallas_call outputs carry no vma metadata
    )

    @partial(jax.jit, donate_argnums=(0, 1))
    def step(params, opt_state, t):
        loss, grads = loss_and_grad(params, t)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    def init(params):
        params = jax.device_put(params, rep)
        return params, jax.device_put(opt.init(params), rep)

    return step, init


def make_generic_sharded_train_step(
    g: GridSpec,
    w: PhysWeights,
    generate_fn,
    mesh,
    params0,
    learning_rate: float = 1e-3,
):
    """Model-agnostic sharded training step (GSPMD arm) for ANY
    differentiable field generator `generate_fn(params, t) ->
    FieldSnapshots` — the multi-chip counterpart of
    train.make_generic_train_step, so extension models (e.g. the NGP hash
    field) train on a mesh exactly like the core MLP: params replicated,
    fields z-sharded, halo collectives and the gradient all-reduce
    inserted by the partitioner.

    Returns (step_fn, init_fn): step(params, opt_state, t) ->
    (params', opt_state', loss).
    """
    import optax

    opt = optax.adam(learning_rate)
    rep = replicated(mesh)

    def loss_of(params, t):
        fs = generate_fn(params, t)
        fs = jax.tree_util.tree_map(
            jax.lax.with_sharding_constraint, fs, field_shardings(mesh)
        )
        return ops.total_loss(g, w, fs)

    @partial(jax.jit, donate_argnums=(0, 1))
    def step(params, opt_state, t):
        loss, grads = jax.value_and_grad(loss_of)(params, t)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    def init(params=None):
        params = jax.device_put(params0 if params is None else params, rep)
        return params, jax.device_put(opt.init(params), rep)

    return step, init


def make_sharded_train_step_2d(
    g: GridSpec,
    w: PhysWeights,
    mcfg: MLPGridConfig,
    mesh,
    learning_rate: float = 1e-3,
):
    """Sharded training step over a 2-D ("z", "h") mesh: spatial data
    parallelism on the grid's z axis PLUS tensor parallelism on the MLP
    hidden dimension (W1 column-sharded, W2 row-sharded — the contraction
    over H becomes a partial-sum + psum inserted by the partitioner).

    Returns (step_fn, init_fn) like make_sharded_train_step.
    """
    import optax

    opt = optax.adam(learning_rate)
    rep = NamedSharding(mesh, P())
    param_sh = {
        "W1": NamedSharding(mesh, P(None, "h")),
        "b1": NamedSharding(mesh, P("h")),
        "W2": NamedSharding(mesh, P("h", None)),
        "b2": NamedSharding(mesh, P()),
    }
    s = NamedSharding(mesh, P("z", None, None))
    v = NamedSharding(mesh, P(None, "z", None, None))

    def loss_of(params, t):
        fs = fields_mod.generate_fields(g, mcfg, params, t, g.dt)
        fs = FieldSnapshots(
            sigma_tm1=jax.lax.with_sharding_constraint(fs.sigma_tm1, s),
            sigma_t=jax.lax.with_sharding_constraint(fs.sigma_t, s),
            sigma_tp1=jax.lax.with_sharding_constraint(fs.sigma_tp1, s),
            u_tm1=jax.lax.with_sharding_constraint(fs.u_tm1, v),
            u_t=jax.lax.with_sharding_constraint(fs.u_t, v),
            u_tp1=jax.lax.with_sharding_constraint(fs.u_tp1, v),
        )
        return ops.total_loss(g, w, fs)

    @partial(jax.jit, donate_argnums=(0, 1))
    def step(params, opt_state, t):
        loss, grads = jax.value_and_grad(loss_of)(params, t)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    def init(params):
        params = {k: jax.device_put(v_, param_sh[k]) for k, v_ in params.items()}
        opt_state = opt.init(params)
        return params, opt_state

    return step, init
