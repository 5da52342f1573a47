"""Multi-chip == single-chip parity on an 8-device CPU mesh.

New capability relative to the reference (strictly single-GPU, survey §2).
Covers both arms: the GSPMD-partitioned staged path (XLA inserts the halo
collectives) and the shard_map explicit-halo path (ppermute halos for the
residual and loss ops; recomputed halo rows from the kernel pair of
pallas/fieldgen.py, in interpret mode here, for the fused train step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phys_autodiff_tpu import ops
from phys_autodiff_tpu.models import mlp
from phys_autodiff_tpu.ops.stencil import FieldSnapshots
from phys_autodiff_tpu.parallel import (
    loss_forward_halo_sharded,
    make_mesh,
    make_sharded_fused_train_step,
    make_sharded_train_step,
    residuals_halo_sharded,
    residuals_sharded,
    shard_fields,
)
from phys_autodiff_tpu.ref import manufactured
from phys_autodiff_tpu.train import TrainConfig, init_state, make_train_step
from phys_autodiff_tpu.utils.config import (
    GridSpec,
    MLPDims,
    MLPGridConfig,
    PhysWeights,
)
from phys_autodiff_tpu.utils.metrics import max_abs_err, rel_l2_err

L = 2 * np.pi
N_DEV = 8


def _grid(periodic=True, nx=32):
    # nz = 16 -> 2 planes per device on the 8-device mesh
    return GridSpec(
        nx=nx, ny=16, nz=16, hx=L / nx, hy=L / 16, hz=L / 16, dt=1e-3,
        periodic=periodic,
    )


def _snapshots(g):
    f = manufactured.solution2_fields(g, 0.7)
    return FieldSnapshots(**{k: jnp.asarray(v) for k, v in f.items()})


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= N_DEV, "conftest must provide 8 CPU devices"
    return make_mesh(N_DEV)


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
def test_gspmd_residuals_match_single_device(mesh, periodic):
    g = _grid(periodic)
    fs = _snapshots(g)
    rs_1, ru_1 = jax.jit(lambda x: ops.residuals(g, x))(fs)
    fs_sharded = shard_fields(mesh, fs)
    rs_n, ru_n = jax.jit(lambda x: residuals_sharded(g, mesh, x))(fs_sharded)
    assert rel_l2_err(rs_n, rs_1) <= 1e-7
    assert max_abs_err(rs_n, rs_1) <= 1e-6
    assert rel_l2_err(ru_n, ru_1) <= 1e-7


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
def test_shard_map_fused_residuals_match_single_device(mesh, periodic):
    g = _grid(periodic)
    fs = _snapshots(g)
    rs_1, ru_1 = jax.jit(lambda x: ops.residuals(g, x))(fs)
    rs_n, ru_n = jax.jit(
        lambda x: residuals_halo_sharded(g, mesh, x)
    )(shard_fields(mesh, fs))
    assert rel_l2_err(rs_n, rs_1) <= 1e-7
    assert max_abs_err(rs_n, rs_1) <= 1e-6
    assert rel_l2_err(ru_n, ru_1) <= 1e-7


def test_sharded_loss_matches_single_device(mesh):
    g = _grid()
    fs = _snapshots(g)
    w = PhysWeights(w_sigma=1.7, w_u=0.9)
    ls_1, lu_1 = jax.jit(lambda x: ops.loss_forward(g, w, x))(fs)

    def sharded_loss(x):
        rs, ru = residuals_sharded(g, mesh, x)
        return ops.loss_terms(g, w, rs, ru)

    ls_n, lu_n = jax.jit(sharded_loss)(shard_fields(mesh, fs))
    # f32 reduction order differs between the partitioned (per-shard + psum)
    # and single-device sums; the 1e-7 doctrine is carried by the f64 arm.
    assert abs(float(ls_n) - float(ls_1)) / abs(float(ls_1)) <= 1e-4
    assert abs(float(lu_n) - float(lu_1)) / abs(float(lu_1)) <= 1e-4


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
def test_sharded_fused_loss_deterministic_1e7(mesh, periodic):
    """The halo sharded loss (ppermute halos + per-shard plane partials +
    fixed-order plane-partial reduction) meets the single-chip planewise
    loss at the 1e-7 doctrine — per-plane partials are computed by
    identical programs and the final chain has mesh-independent
    association. (The unconstrained psum arm above is held only to 1e-4.)"""
    from phys_autodiff_tpu.ops.loss import loss_forward_planewise

    g = _grid(periodic)
    fs = _snapshots(g)
    w = PhysWeights(w_sigma=1.7, w_u=0.9)
    ls_1, lu_1 = jax.jit(lambda x: loss_forward_planewise(g, w, x))(fs)
    ls_n, lu_n = jax.jit(
        lambda x: loss_forward_halo_sharded(g, w, mesh, x)
    )(shard_fields(mesh, fs))
    assert abs(float(ls_n) - float(ls_1)) / abs(float(ls_1)) <= 1e-7
    assert abs(float(lu_n) - float(lu_1)) / abs(float(lu_1)) <= 1e-7


def test_sharded_planewise_staged_loss_1e7(mesh):
    """The staged GSPMD loss with the plane-partial deterministic reduction
    also meets 1e-7 against the single-chip planewise loss."""
    from phys_autodiff_tpu.ops.loss import loss_forward_planewise

    g = _grid()
    fs = _snapshots(g)
    w = PhysWeights(w_sigma=1.7, w_u=0.9)
    ls_1, lu_1 = jax.jit(lambda x: loss_forward_planewise(g, w, x))(fs)

    def sharded(x):
        from phys_autodiff_tpu.ops.loss import plane_partials, sum_partials

        rs, ru = residuals_sharded(g, mesh, x)
        return sum_partials(g, w, plane_partials(rs, ru))

    ls_n, lu_n = jax.jit(sharded)(shard_fields(mesh, fs))
    assert abs(float(ls_n) - float(ls_1)) / abs(float(ls_1)) <= 1e-7
    assert abs(float(lu_n) - float(lu_1)) / abs(float(lu_1)) <= 1e-7


def _single_fused_step(g, w, mcfg, params, t, lr):
    """Reference: one single-device fused step (loss_fn(use_fused=True),
    the kernel pair) + Adam."""
    import optax

    from phys_autodiff_tpu.train.loop import loss_fn

    l1, gp1 = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(g, w, mcfg, p, t, True)))(params)
    opt = optax.adam(lr)
    up, _ = opt.update(gp1, opt.init(params), params)
    return l1, optax.apply_updates(params, up)


def test_sharded_fused_train_step_matches_single(mesh):
    """The sharded FUSED step (per-shard kernel-pair rows with recomputed
    halo rows, psum'd gradients, fixed-order loss) matches the single-chip
    fused step."""
    g = _grid()
    w = PhysWeights()
    mcfg = MLPGridConfig(dims=MLPDims(H=32))
    params = mlp.init_params(mcfg.dims, seed=5)
    t = jnp.float32(0.25)
    l1, p1 = _single_fused_step(g, w, mcfg, params, t, 1e-3)
    step_n, init_n = make_sharded_fused_train_step(g, w, mcfg, mesh, 1e-3)
    pn, on = init_n(params)
    pn, on, ln = step_n(pn, on, t)
    # the two loss reductions associate differently (whole-grid sum vs
    # plane partials in z order)
    assert abs(float(ln) - float(l1)) / abs(float(l1)) <= 5e-6
    for k in p1:
        assert rel_l2_err(pn[k], p1[k]) <= 1e-6, k
    # and a second step stays finite / decreases the loss
    pn, on, ln2 = step_n(pn, on, t)
    assert np.isfinite(float(ln2)) and float(ln2) < float(ln)


def test_sharded_train_step_matches_single_device(mesh):
    """One full sharded train step (replicated params, z-sharded fields,
    all-reduced gradients) vs the single-device step."""
    g = _grid()
    w = PhysWeights()
    mcfg = MLPGridConfig(dims=MLPDims(H=32))
    cfg = TrainConfig(steps=1, learning_rate=1e-3, t=0.25, seed=5)

    # single-device
    state = init_state(cfg, mcfg)
    step1 = make_train_step(g, w, mcfg, cfg)
    state1, loss1 = step1(state)

    # sharded
    step_n, init_n = make_sharded_train_step(g, w, mcfg, mesh, cfg.learning_rate)
    params_n, opt_n = init_n(mlp.init_params(mcfg.dims, seed=cfg.seed))
    params_n, opt_n, loss_n = step_n(params_n, opt_n, jnp.float32(cfg.t))

    assert abs(float(loss_n) - float(loss1)) / abs(float(loss1)) <= 1e-6
    for k in state1.params:
        assert rel_l2_err(params_n[k], state1.params[k]) <= 1e-6, k


@pytest.mark.parametrize(
    "scheme,nx,ny,periodic",
    [("upwind", 32, 16, True), ("central", 24, 8, False),
     ("upwind", 24, 8, False), ("central", 20, 6, True)],
    ids=["upwind-periodic", "central-clamp", "upwind-clamp", "central-odd"],
)
def test_sharded_fused_step_matches_single_classes(mesh, scheme, nx, ny,
                                                    periodic):
    """The sharded fused step honours the scheme and the boundary mode (the
    clamped halo rows at the global z edges) on every grid class, including
    planes whose cell count leaves a masked tile tail."""
    g = GridSpec(nx=nx, ny=ny, nz=16, hx=0.3, hy=0.35, hz=0.4, dt=1e-2,
                 scheme=scheme, periodic=periodic)
    w = PhysWeights()
    mcfg = MLPGridConfig(dims=MLPDims(H=32))
    params = mlp.init_params(mcfg.dims, seed=5)
    t = jnp.float32(0.25)
    l1, p1 = _single_fused_step(g, w, mcfg, params, t, 1e-3)
    step_n, init_n = make_sharded_fused_train_step(g, w, mcfg, mesh, 1e-3)
    pn, on = init_n(params)
    pn, on, ln = step_n(pn, on, t)
    assert abs(float(ln) - float(l1)) / abs(float(l1)) <= 5e-6
    for k in p1:
        assert rel_l2_err(pn[k], p1[k]) <= 1e-6, k


def test_shard_map_fused_residuals_upwind_scheme(mesh):
    """Regression: the per-shard local GridSpec must inherit the advection
    scheme — built without scheme=, it would silently compute CENTRAL
    differences for upwind grids on the mesh."""
    import dataclasses

    g = dataclasses.replace(_grid(), scheme="upwind")
    fs = _snapshots(g)
    rs_1, ru_1 = jax.jit(lambda x: ops.residuals(g, x))(fs)
    rs_n, ru_n = jax.jit(
        lambda x: residuals_halo_sharded(g, mesh, x)
    )(shard_fields(mesh, fs))
    assert rel_l2_err(rs_n, rs_1) <= 1e-7
    assert max_abs_err(rs_n, rs_1) <= 1e-6
    assert rel_l2_err(ru_n, ru_1) <= 1e-7


def test_sharded_fused_loss_upwind_1e7(mesh):
    """The fixed-order sharded halo loss honors the upwind scheme too, and
    is mesh-independent at the 1e-7 doctrine: the 8-device result equals
    the same program on a 1-device mesh. (The full-grid planewise program
    fuses the upwind selects differently and sits 7e-7 away in L_u on the
    CPU backend.)"""
    import dataclasses

    g = dataclasses.replace(_grid(), scheme="upwind")
    fs = _snapshots(g)
    w = PhysWeights(w_sigma=1.1, w_u=0.6)
    mesh1 = make_mesh(1)
    ls_1, lu_1 = jax.jit(
        lambda x: loss_forward_halo_sharded(g, w, mesh1, x)
    )(shard_fields(mesh1, fs))
    ls_n, lu_n = jax.jit(
        lambda x: loss_forward_halo_sharded(g, w, mesh, x)
    )(shard_fields(mesh, fs))
    assert abs(float(ls_n) - float(ls_1)) / abs(float(ls_1)) <= 1e-7
    assert abs(float(lu_n) - float(lu_1)) / abs(float(lu_1)) <= 1e-7


def test_generic_sharded_train_step_ngp(mesh):
    """The model-agnostic GSPMD sharded step trains the NGP hash-field
    extension on the mesh (params replicated, fields z-sharded) with a
    finite, decreasing loss."""
    from phys_autodiff_tpu.models import ngp
    from phys_autodiff_tpu.models.hash_encoder import HashEncodingConfig
    from phys_autodiff_tpu.parallel.sharded import make_generic_sharded_train_step

    g = _grid()
    ncfg = ngp.NGPFieldConfig(
        encoding=HashEncodingConfig(
            num_levels=3, features_per_level=2, log2_table_size=10,
            base_resolution=4, max_resolution=16,
        ),
        hidden=16,
    )
    params0 = ngp.init_ngp_params(ncfg, seed=2)
    step, init = make_generic_sharded_train_step(
        g,
        PhysWeights(),
        lambda p, t: ngp.generate_fields(g, ncfg, p, t, g.dt),
        mesh,
        params0,
        learning_rate=3e-3,
    )
    params, opt = init()
    losses = []
    t = jnp.float32(0.3)
    for _ in range(8):
        params, opt, loss = step(params, opt, t)
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_generic_sharded_train_step_solenoidal(mesh):
    """The vector-potential head trains on the mesh through the same
    model-agnostic GSPMD step: loss decreases, multi-chip first-step loss
    matches single-chip, and the trained velocity stays EXACTLY
    divergence-free (incompressibility is structural — sharding cannot
    break it)."""
    from phys_autodiff_tpu.models import mlp as mlp_mod
    from phys_autodiff_tpu.models import solenoidal
    from phys_autodiff_tpu.ops.diagnostics import divergence
    from phys_autodiff_tpu.parallel.sharded import (
        make_generic_sharded_train_step,
    )
    from phys_autodiff_tpu.utils.config import MLPDims, MLPGridConfig

    g = _grid()
    mcfg = MLPGridConfig(dims=MLPDims(H=16))
    params0 = mlp_mod.init_params(mcfg.dims, seed=3)
    gen = lambda p, t: solenoidal.generate_fields_solenoidal(
        g, mcfg, p, t, g.dt)
    t = jnp.float32(0.3)
    # single-chip loss BEFORE training (the sharded step donates its
    # param buffers, which alias params0 after init's device_put)
    from phys_autodiff_tpu import ops as ops_mod

    single = float(ops_mod.total_loss(g, PhysWeights(), gen(params0, t)))
    step, init = make_generic_sharded_train_step(
        g, PhysWeights(), gen, mesh, params0, learning_rate=3e-3)
    params, opt = init()
    losses = []
    for _ in range(10):
        params, opt, loss = step(params, opt, t)
        losses.append(float(loss))
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0], losses
    # multi-chip first step agrees (same math; GSPMD reduction ~1e-6)
    assert abs(single - losses[0]) / single <= 1e-5, (single, losses[0])
    # structural incompressibility survives sharded training
    _, u = solenoidal.grid_infer_solenoidal(g, mcfg, params, 0.3)
    umax = float(jnp.max(jnp.abs(u))) + 1e-30
    assert float(jnp.max(jnp.abs(divergence(g, u)))) <= 1e-5 * umax
