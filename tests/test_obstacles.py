"""Tests for ops/obstacles.py + the obstacle-aware Euler solver.

Oracles:
  * degenerate mask (all fluid) == project_cg's operator on the same RHS,
  * no-slip is an exact fixed point of semi-Lagrangian advection (solid
    cells depart from themselves), pinned bitwise across a rollout,
  * the masked projection cuts interior-fluid divergence by a large
    factor and leaves solids at exactly zero,
  * a buoyant plume under a solid ceiling never enters the solid, while
    the same plume without the obstacle does reach those cells (the mask
    is load-bearing, not vacuously satisfied),
  * jax.grad flows through the masked rollout (obstacle-aware
    differentiable simulation).
"""

import jax
import jax.numpy as jnp
import numpy as np

from phys_autodiff_tpu.apps import euler
from phys_autodiff_tpu.ops import obstacles
from phys_autodiff_tpu.ops.diagnostics import divergence
from phys_autodiff_tpu.ops.projection import project_cg
from phys_autodiff_tpu.utils.config import GridSpec


def _grid(periodic=True, nx=16, ny=12, nz=12):
    return GridSpec(nx=nx, ny=ny, nz=nz, hx=0.5, hy=0.25, hz=0.4,
                    dt=1e-3, periodic=periodic)


def _smooth_u(g, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(
        np.arange(g.nz), np.arange(g.ny), np.arange(g.nx), indexing="ij"
    )
    comps = []
    for _ in range(3):
        kx, ky, kz = rng.integers(1, 3, size=3)
        ph = rng.uniform(0, 2 * np.pi, size=3)
        comps.append(
            (
                np.sin(2 * np.pi * kx * x / g.nx + ph[0])
                * np.sin(2 * np.pi * ky * y / g.ny + ph[1])
                * np.sin(2 * np.pi * kz * z / g.nz + ph[2])
            ).astype(np.float32)
        )
    return jnp.asarray(np.stack(comps)) * scale


def _box(g):
    return obstacles.box_mask(g, (4, 4, 5), (8, 8, 10))


def test_mask_builders():
    g = _grid()
    m = _box(g)
    assert m.shape == g.shape and m.dtype == jnp.float32
    assert float(m[5, 5, 7]) == 0.0 and float(m[0, 0, 0]) == 1.0
    assert float(jnp.sum(1.0 - m)) == 4 * 4 * 5

    s = obstacles.sphere_mask(g, (6, 6, 8), 1.0)
    assert float(s[6, 6, 8]) == 0.0  # center is solid
    assert float(s[0, 0, 0]) == 1.0
    # union of solids: solid wherever either is solid
    u = obstacles.union(m, s)
    assert float(jnp.sum(1.0 - u)) >= float(jnp.sum(1.0 - m))
    c = obstacles.complement(m)
    np.testing.assert_array_equal(np.asarray(m + c), 1.0)
    obstacles.validate_mask(g, m)  # passes
    try:
        obstacles.validate_mask(g, m * 0.5)
        raise RuntimeError("expected non-binary mask to be rejected")
    except ValueError:  # ValueError, not assert
        pass


def test_all_fluid_mask_matches_project_cg():
    """mask == 1 degenerates the masked operator to project_cg's
    (identical CGNR problem up to the mean-removal term, which the
    all-ones mask makes identical too)."""
    g = _grid(periodic=False)
    u = _smooth_u(g, 3)
    ones = jnp.ones(g.shape, jnp.float32)
    a = obstacles.project_masked(g, u, ones, maxiter=60)
    b = project_cg(g, u, maxiter=60)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=0, atol=5e-5)


def test_masked_projection_cuts_fluid_divergence():
    g = _grid()
    m = _box(g)
    u = _smooth_u(g, 4)
    before = float(obstacles.fluid_divergence(g, obstacles.apply_no_slip(u, m), m))
    u_p = jax.jit(
        lambda v: obstacles.project_masked(g, v, m, maxiter=200)
    )(u)
    after = float(obstacles.fluid_divergence(g, u_p, m))
    assert after < before / 20.0, (before, after)
    # solids exactly zero
    solid = np.asarray(1.0 - m, bool)
    assert np.all(np.asarray(u_p)[:, solid] == 0.0)


def test_masked_projection_clamp_mode():
    g = _grid(periodic=False)
    m = _box(g)
    u = _smooth_u(g, 5)
    before = float(obstacles.fluid_divergence(g, obstacles.apply_no_slip(u, m), m))
    u_p = obstacles.project_masked(g, u, m, maxiter=200)
    after = float(obstacles.fluid_divergence(g, u_p, m))
    assert after < before / 10.0, (before, after)


def test_no_slip_fixed_point_bitwise_over_rollout():
    """Solid-cell velocity AND density stay exactly zero across a
    semi-Lagrangian rollout: u = 0 at a solid cell makes the backtrace
    depart from itself, and every stage re-masks."""
    g = _grid()
    m = _box(g)
    rng = np.random.default_rng(6)
    sigma0 = jnp.asarray(
        np.abs(rng.normal(size=g.shape)).astype(np.float32)) * m
    u0 = obstacles.apply_no_slip(_smooth_u(g, 6, scale=2.0), m)
    cfg = euler.EulerConfig(dt=0.05, steps=4, buoyancy=0.5,
                            confinement=0.2, cg_maxiter=40)
    final, diag = jax.jit(
        lambda s: euler.rollout(g, s, cfg, mask=m)
    )(euler.EulerState(sigma0, u0))
    solid = np.asarray(1.0 - m, bool)
    assert np.all(np.asarray(final.u)[:, solid] == 0.0)
    assert np.all(np.asarray(final.sigma)[solid] == 0.0)
    assert np.all(np.isfinite(np.asarray(final.sigma)))
    assert np.all(np.isfinite(np.asarray(diag["max_abs_div"])))


def test_obstacle_blocks_plume_that_otherwise_passes():
    """A buoyant plume rising under a solid slab: without the mask the
    smoke reaches the slab cells; with it they stay exactly empty."""
    g = _grid(nz=16)
    # solid slab across the whole xy extent at z in [8, 10)
    m = obstacles.box_mask(g, (8, 0, 0), (10, g.ny, g.nx))
    sigma0 = np.zeros(g.shape, np.float32)
    sigma0[2:5, 4:8, 6:10] = 1.0  # smoke blob below the slab
    sigma0 = jnp.asarray(sigma0)
    u0 = jnp.zeros((3,) + g.shape, jnp.float32)
    cfg = euler.EulerConfig(dt=0.05, steps=16, buoyancy=8.0, cg_maxiter=40)
    free, _ = jax.jit(
        lambda s: euler.rollout(g, s, cfg)
    )(euler.EulerState(sigma0, u0))
    blocked, _ = jax.jit(
        lambda s: euler.rollout(g, s, cfg, mask=m)
    )(euler.EulerState(sigma0, u0))
    slab = np.asarray(1.0 - m, bool)
    free_in_slab = float(np.abs(np.asarray(free.sigma))[slab].max())
    blocked_in_slab = float(np.abs(np.asarray(blocked.sigma))[slab].max())
    assert free_in_slab > 1e-3, free_in_slab  # the test is non-vacuous
    assert blocked_in_slab == 0.0
    # smoke still exists (it went somewhere, not to zero)
    assert float(jnp.sum(blocked.sigma)) > 0.1 * float(jnp.sum(sigma0))


def test_masked_rollout_is_differentiable():
    g = _grid(nx=12, ny=8, nz=8)
    m = obstacles.box_mask(g, (3, 3, 4), (5, 5, 8))
    rng = np.random.default_rng(7)
    sigma0 = jnp.asarray(
        np.abs(rng.normal(size=g.shape)).astype(np.float32)) * m
    target = jnp.asarray(
        np.abs(rng.normal(size=g.shape)).astype(np.float32)) * m
    cfg = euler.EulerConfig(dt=0.05, steps=2, cg_maxiter=20)
    u0 = _smooth_u(g, 8)
    loss, grad = jax.jit(jax.value_and_grad(
        lambda u: euler.rollout_loss(g, u, sigma0, target, cfg, mask=m)
    ))(u0)
    assert np.isfinite(float(loss))
    ga = np.asarray(grad)
    assert np.all(np.isfinite(ga))
    assert float(np.abs(ga).max()) > 0.0


def test_masked_rollout_gspmd_matches_single_chip():
    """The obstacle-aware rollout is pure jnp (masks are multiplies, the
    projection is CG), so the GSPMD partitioner runs it multi-chip
    unchanged: z-shard the state AND the mask over the 8-device mesh and
    the rollout must match the single-chip result (fp tolerance — CG dot
    products psum in a different order)."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from phys_autodiff_tpu.parallel.mesh import Z_AXIS, make_mesh

    g = _grid(nx=16, ny=8, nz=16)
    m = obstacles.box_mask(g, (5, 2, 4), (11, 6, 12))
    rng = np.random.default_rng(9)
    sigma0 = jnp.asarray(
        np.abs(rng.normal(size=g.shape)).astype(np.float32)) * m
    u0 = obstacles.apply_no_slip(_smooth_u(g, 9), m)
    cfg = euler.EulerConfig(dt=0.05, steps=3, buoyancy=1.0, cg_maxiter=30)

    single, _ = jax.jit(
        lambda s, u: euler.rollout(g, euler.EulerState(s, u), cfg, mask=m)
    )(sigma0, u0)

    mesh = make_mesh(8)
    sh_s = NamedSharding(mesh, P(Z_AXIS))
    sh_u = NamedSharding(mesh, P(None, Z_AXIS))
    m_d = jax.device_put(m, sh_s)
    multi, _ = jax.jit(
        lambda s, u, mm: euler.rollout(
            g, euler.EulerState(s, u), cfg, mask=mm)
    )(jax.device_put(sigma0, sh_s), jax.device_put(u0, sh_u), m_d)

    np.testing.assert_allclose(
        np.asarray(multi.sigma), np.asarray(single.sigma),
        rtol=0, atol=2e-5)
    np.testing.assert_allclose(
        np.asarray(multi.u), np.asarray(single.u), rtol=0, atol=2e-5)
    solid = np.asarray(1.0 - m, bool)
    assert np.all(np.asarray(multi.u)[:, solid] == 0.0)


def test_fluid_divergence_interior_only():
    """fluid_divergence ignores the boundary layer: a velocity whose
    divergence is nonzero ONLY inside the solid + its one-cell ring
    reads as zero."""
    g = _grid()
    m = _box(g)
    # a field supported strictly inside the solid box
    u = np.zeros((3,) + g.shape, np.float32)
    u[0, 5:7, 5:7, 6:9] = 1.0
    u = jnp.asarray(u)
    assert float(jnp.max(jnp.abs(divergence(g, u)))) > 0.0
    assert float(obstacles.fluid_divergence(g, u, m)) == 0.0


def test_entry_sigma_masking_prevents_solid_leak():
    """A density initialized INSIDE the solid must not
    leak into fluid cells — euler_step masks the incoming sigma, not just
    the incoming velocity, so rollout/rollout_loss callers need not
    pre-mask their initial state."""
    g = _grid()
    mask = _box(g)
    # all the smoke sits inside the solid box; a strong flow tries to
    # carry it out
    sigma0 = jnp.asarray((1.0 - np.asarray(mask)) * 0.25, jnp.float32)
    u0 = _smooth_u(g, seed=3, scale=50.0)
    cfg = euler.EulerConfig(dt=1e-3, steps=3, projection="none")
    state = euler.EulerState(sigma0, u0)
    for _ in range(3):
        state = euler.euler_step(g, state, cfg, mask=mask)
    np.testing.assert_array_equal(np.asarray(state.sigma), 0.0)


def test_validate_mask_raises_value_error():
    """validate_mask raises (not asserts, so it
    survives python -O) on shape and non-binary value errors."""
    import pytest

    g = _grid()
    with pytest.raises(ValueError, match="shape"):
        obstacles.validate_mask(g, jnp.ones((2, 3, 4), jnp.float32))
    bad = jnp.full(g.shape, 0.5, jnp.float32)
    with pytest.raises(ValueError, match="0/1"):
        obstacles.validate_mask(g, bad)
    ok = obstacles.validate_mask(g, _box(g))
    assert ok.shape == g.shape


def test_fit_initial_velocity_accepts_source():
    """The convenience fitter passes source= through to
    rollout_loss, so emitter-past-obstacle inverse problems run."""
    g = _grid(nx=8, ny=8, nz=8)
    mask = obstacles.box_mask(g, (3, 3, 3), (5, 5, 5))
    rate = jnp.zeros(g.shape, jnp.float32).at[1, 1, 1].set(2.0)
    src = euler.EulerSource(
        sigma_rate=rate, force=jnp.zeros((3,) + g.shape, jnp.float32))
    cfg = euler.EulerConfig(dt=1e-3, steps=2, projection="none")
    sigma0 = jnp.zeros(g.shape, jnp.float32)
    # target: what the sourced rollout actually produces from rest
    final, _ = euler.rollout(
        g, euler.EulerState(sigma0, jnp.zeros((3,) + g.shape, jnp.float32)),
        cfg, mask=mask, source=src)
    u0, losses = euler.fit_initial_velocity(
        g, sigma0, final.sigma, cfg, opt_steps=2, learning_rate=0.1,
        mask=mask, source=src)
    assert u0.shape == (3,) + g.shape
    assert np.all(np.isfinite(np.asarray(losses)))
    # from-rest start + the same source => the loss starts near zero
    assert float(losses[0]) < 1e-8
