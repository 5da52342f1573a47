"""Distributed (pencil-decomposed) FFT projection vs single-chip, on the
8-device CPU mesh. The sharded projector factors the 3-D spectrum into
local x/y FFTs + two all_to_all transposes + a z FFT; parity against
ops.projection.project_fft is tolerance-level (different FFT evaluation
order), and the result must satisfy the same contracts (discrete div at
rounding, idempotence)."""

import jax
import jax.numpy as jnp
import numpy as np

from phys_autodiff_tpu.ops import diagnostics, projection
from phys_autodiff_tpu.parallel import make_mesh
from phys_autodiff_tpu.parallel.spectral import project_fft_sharded
from phys_autodiff_tpu.utils.config import GridSpec
from phys_autodiff_tpu.utils.metrics import rel_l2_err

N_DEV = 8


def _grid(nx=16, ny=16, nz=16):
    return GridSpec(nx=nx, ny=ny, nz=nz, hx=0.5, hy=0.25, hz=0.4, dt=1e-3)


def _rand_u(g, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.normal(size=(3,) + g.shape).astype(np.float32))


def test_sharded_projection_matches_single_chip():
    g = _grid()
    u = _rand_u(g, 1)
    mesh = make_mesh(N_DEV)
    out_s = np.asarray(project_fft_sharded(g, u, mesh))
    out_1 = np.asarray(jax.jit(lambda v: projection.project_fft(g, v))(u))
    assert rel_l2_err(out_s, out_1) <= 1e-6, rel_l2_err(out_s, out_1)


def test_sharded_projection_kills_divergence():
    g = _grid(nx=12, ny=24, nz=8)  # ny, nz divisible by 8; odd-ish x
    u = _rand_u(g, 2)
    mesh = make_mesh(N_DEV)
    out = project_fft_sharded(g, u, mesh)
    before = float(jnp.max(jnp.abs(diagnostics.divergence(g, u))))
    after = float(jnp.max(jnp.abs(diagnostics.divergence(g, out))))
    assert after <= 2e-5 * before, (before, after)


def test_sharded_projection_idempotent():
    g = _grid()
    u = _rand_u(g, 3)
    mesh = make_mesh(N_DEV)
    once = project_fft_sharded(g, u, mesh)
    twice = project_fft_sharded(g, jnp.asarray(np.asarray(once)), mesh)
    assert rel_l2_err(np.asarray(twice), np.asarray(once)) <= 1e-5


def test_sharded_euler_rollout_matches_single_chip():
    """Full multi-chip Euler rollout (advect + buoyancy + viscosity +
    pencil-FFT projection + density diffusion) vs the single-chip rollout:
    every stage active, 4 steps, fp-tolerance parity (the pencil FFT
    evaluates in a different order than the fused rfftn)."""
    from phys_autodiff_tpu.apps import euler

    g = _grid()
    rng = np.random.default_rng(5)
    sigma0 = jnp.asarray(rng.uniform(size=g.shape).astype(np.float32))
    u0 = jnp.asarray(
        (0.5 * rng.normal(size=(3,) + g.shape)).astype(np.float32)
    )
    cfg = euler.EulerConfig(dt=0.05, steps=4, buoyancy=0.7,
                            viscosity=0.05, diffusivity=0.02)
    state0 = euler.EulerState(sigma0, u0)
    f1, d1 = jax.jit(lambda s: euler.rollout(g, s, cfg))(state0)
    mesh = make_mesh(N_DEV)
    fs, ds = euler.rollout_sharded(g, state0, cfg, mesh)
    assert rel_l2_err(np.asarray(fs.sigma), np.asarray(f1.sigma)) <= 1e-5
    assert rel_l2_err(np.asarray(fs.u), np.asarray(f1.u)) <= 1e-5
    np.testing.assert_allclose(
        np.asarray(ds["kinetic_energy"]),
        np.asarray(d1["kinetic_energy"]), rtol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(ds["max_cfl"]), np.asarray(d1["max_cfl"]), rtol=1e-5
    )
    # divergence after the distributed projection is rounding-level too
    assert float(jnp.max(ds["max_abs_div"])) <= 5e-5


def test_sharded_diffusion_matches_single_chip():
    from phys_autodiff_tpu.ops import diffusion
    from phys_autodiff_tpu.parallel.mesh import Z_AXIS
    from phys_autodiff_tpu.parallel.spectral import shard_local_diffuse_fft
    from jax.sharding import NamedSharding, PartitionSpec as P

    g = _grid()
    f = jnp.asarray(
        np.random.default_rng(6).normal(size=g.shape).astype(np.float32)
    )
    ref = np.asarray(jax.jit(
        lambda v: diffusion.diffuse_fft(g, v, 0.4, 0.1)
    )(f))
    mesh = make_mesh(N_DEV)
    body = shard_local_diffuse_fft(g, N_DEV, 0.4, 0.1)
    fn = jax.shard_map(body, mesh=mesh, in_specs=P(Z_AXIS),
                       out_specs=P(Z_AXIS), check_vma=False)
    out = np.asarray(jax.jit(fn)(
        jax.device_put(f, NamedSharding(mesh, P(Z_AXIS)))
    ))
    assert rel_l2_err(out, ref) <= 1e-6, rel_l2_err(out, ref)


def test_sharded_projection_uneven_z_rejected():
    g = GridSpec(nx=8, ny=8, nz=12, hx=0.5, hy=0.5, hz=0.5, dt=1e-3)
    mesh = make_mesh(N_DEV)
    u = _rand_u(g, 4)
    try:
        project_fft_sharded(g, u, mesh)
    except AssertionError:
        return
    raise AssertionError("nz % n != 0 must be rejected")


def test_sharded_euler_maccormack_confinement_matches_single_chip():
    """Limited MacCormack advection + vorticity
    confinement) through the sharded rollout: fp-tolerance parity vs the
    single-chip rollout (the pencil FFT evaluates in a different order)."""
    from phys_autodiff_tpu.apps import euler

    g = _grid()
    rng = np.random.default_rng(7)
    sigma0 = jnp.asarray(rng.uniform(size=g.shape).astype(np.float32))
    u0 = jnp.asarray(
        (0.5 * rng.normal(size=(3,) + g.shape)).astype(np.float32)
    )
    cfg = euler.EulerConfig(dt=0.05, steps=3, buoyancy=0.4,
                            confinement=2.0, advection="maccormack")
    state0 = euler.EulerState(sigma0, u0)
    f1, d1 = jax.jit(lambda s: euler.rollout(g, s, cfg))(state0)
    mesh = make_mesh(N_DEV)
    fs, ds = euler.rollout_sharded(g, state0, cfg, mesh)
    assert rel_l2_err(np.asarray(fs.sigma), np.asarray(f1.sigma)) <= 1e-5
    assert rel_l2_err(np.asarray(fs.u), np.asarray(f1.u)) <= 1e-5
    assert float(jnp.max(ds["max_abs_div"])) <= 5e-5


def test_sharded_remat_rollout_bitwise_matches_plain_sharded():
    """cfg.remat on the SHARDED rollout is a memory knob only: the forward
    pass (and its collectives) must be bitwise identical to the
    non-remat sharded rollout."""
    from phys_autodiff_tpu.apps import euler

    g = _grid()
    rng = np.random.default_rng(12)
    sigma0 = jnp.asarray(rng.uniform(size=g.shape).astype(np.float32))
    u0 = jnp.asarray(
        (0.5 * rng.normal(size=(3,) + g.shape)).astype(np.float32)
    )
    kw = dict(dt=0.05, steps=3, buoyancy=0.7, advection="maccormack",
              confinement=1.0)
    state0 = euler.EulerState(sigma0, u0)
    mesh = make_mesh(N_DEV)
    f1, d1 = euler.rollout_sharded(g, state0, euler.EulerConfig(**kw), mesh)
    f2, d2 = euler.rollout_sharded(
        g, state0, euler.EulerConfig(remat=True, **kw), mesh)
    np.testing.assert_array_equal(np.asarray(f1.sigma), np.asarray(f2.sigma))
    np.testing.assert_array_equal(np.asarray(f1.u), np.asarray(f2.u))
    np.testing.assert_array_equal(
        np.asarray(d1["kinetic_energy"]), np.asarray(d2["kinetic_energy"]))
