"""The M4 advection upwind switch (GridSpec.scheme="upwind").

Reference spec (REQUIREMENT.md:131-134, planned but never built there):
  * consistency with central differences — the difference vanishes in the
    small-velocity limit;
  * stability on random large velocity fields (no NaN blowup);
  * cross-arm consistency (REQUIREMENT.md:219): oracle, staged XLA and the
    fused training path (pallas/fieldgen.py) all honor the same scheme.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phys_autodiff_tpu import ops
from phys_autodiff_tpu.bench.harness import random_fields
from phys_autodiff_tpu.models import mlp
from phys_autodiff_tpu.ops.stencil import FieldSnapshots
from phys_autodiff_tpu.ref import native, oracle
from phys_autodiff_tpu.train.loop import loss_fn
from phys_autodiff_tpu.utils.config import GridSpec, MLPDims, MLPGridConfig, PhysWeights
from phys_autodiff_tpu.utils.metrics import max_abs_err, rel_l2_err

GRID = dict(nx=16, ny=12, nz=8, hx=0.3, hy=0.25, hz=0.2, dt=1e-2)


def _fields(g, u_scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda s, sc=1.0: jnp.asarray(sc * rng.standard_normal(s), jnp.float32)
    return FieldSnapshots(
        sigma_tm1=mk(g.shape), sigma_t=mk(g.shape), sigma_tp1=mk(g.shape),
        u_tm1=mk((3,) + g.shape, u_scale),
        u_t=mk((3,) + g.shape, u_scale),
        u_tp1=mk((3,) + g.shape, u_scale),
    )


def test_small_velocity_consistency():
    """|R_upwind - R_central| -> 0 linearly with the velocity scale (the
    advection terms are the only difference and are O(|u|))."""
    diffs = []
    for eps in (1e-1, 1e-2, 1e-3):
        gc = GridSpec(scheme="central", **GRID)
        gu = GridSpec(scheme="upwind", **GRID)
        fs = _fields(gc, u_scale=eps)
        rs_c, ru_c = ops.residuals(gc, fs)
        rs_u, ru_u = ops.residuals(gu, fs)
        d = float(jnp.max(jnp.abs(rs_c - rs_u))) + float(
            jnp.max(jnp.abs(ru_c - ru_u))
        )
        diffs.append(d)
    # one decade of velocity -> at least ~a decade of difference decay
    assert diffs[1] < 0.2 * diffs[0]
    assert diffs[2] < 0.2 * diffs[1]


def test_constant_velocity_exactness():
    """With constant positive u, the upwind x-derivative is exactly the
    backward difference — checked against a hand-built expectation."""
    g = GridSpec(scheme="upwind", **GRID)
    rng = np.random.default_rng(3)
    s = rng.standard_normal(g.shape).astype(np.float32)
    zeros = np.zeros(g.shape, np.float32)
    u = np.stack([np.full(g.shape, 2.0, np.float32), zeros, zeros])
    fs = FieldSnapshots(
        sigma_tm1=jnp.asarray(s), sigma_t=jnp.asarray(s), sigma_tp1=jnp.asarray(s),
        u_tm1=jnp.asarray(u), u_t=jnp.asarray(u), u_tp1=jnp.asarray(u),
    )
    rs, ru = ops.residuals(g, fs)
    # R_sigma = u_x * (s[i] - s[i-1]) / hx  (dt term zero, div u zero)
    expect = 2.0 * (s - np.roll(s, 1, axis=2)) / np.float32(g.hx)
    assert max_abs_err(rs, expect) <= 1e-5
    assert float(jnp.max(jnp.abs(ru))) <= 1e-6  # (u.grad)u = 0 for constant u


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
def test_upwind_oracle_vs_staged(periodic):
    g = GridSpec(scheme="upwind", periodic=periodic, **GRID)
    fs = _fields(g, seed=7)
    rs_o, ru_o = oracle.residuals(
        g, fs.sigma_tm1, fs.sigma_t, fs.sigma_tp1, fs.u_tm1, fs.u_t, fs.u_tp1
    )
    rs, ru = jax.jit(lambda x: ops.residuals(g, x))(fs)
    assert rel_l2_err(rs, rs_o) <= 3e-4
    assert rel_l2_err(ru, ru_o) <= 3e-4
    assert max_abs_err(rs, rs_o) <= 1e-3


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
def test_upwind_fused_vs_staged(periodic):
    """The fused training loss (kernel-pair fields + XLA residuals) honors
    the upwind scheme: it equals the staged loss of the same model."""
    g = GridSpec(scheme="upwind", periodic=periodic, **GRID)
    w = PhysWeights()
    cfg = MLPGridConfig(dims=MLPDims(H=16))
    params = mlp.init_params(cfg.dims, seed=11)
    l_f = float(loss_fn(g, w, cfg, params, 0.25, use_fused=True))
    l_s = float(loss_fn(g, w, cfg, params, 0.25, use_fused=False))
    assert abs(l_f - l_s) / abs(l_s) < 5e-6


def test_upwind_native_oracle_parity():
    if not native.available():
        pytest.skip("no native toolchain")
    g = GridSpec(scheme="upwind", **GRID)
    fs = _fields(g, seed=13)
    rs_np, ru_np = oracle.residuals(
        g, fs.sigma_tm1, fs.sigma_t, fs.sigma_tp1, fs.u_tm1, fs.u_t, fs.u_tp1
    )
    rs_cc, ru_cc = native.residuals(
        g, fs.sigma_tm1, fs.sigma_t, fs.sigma_tp1, fs.u_tm1, fs.u_t, fs.u_tp1
    )
    assert max_abs_err(rs_cc, rs_np) <= 1e-6
    assert max_abs_err(ru_cc, ru_np) <= 1e-6


def test_upwind_stability_large_velocity():
    """Random large velocity field: residuals stay finite (M4's stability
    criterion at the operator level) in every arm, and gradients flow."""
    g = GridSpec(scheme="upwind", **GRID)
    fs = _fields(g, u_scale=50.0, seed=17)
    rs, ru = ops.residuals(g, fs)
    assert bool(jnp.all(jnp.isfinite(rs))) and bool(jnp.all(jnp.isfinite(ru)))

    w = PhysWeights()
    grads = jax.grad(lambda f: ops.total_loss(g, w, f))(fs)
    assert all(bool(jnp.all(jnp.isfinite(x))) for x in grads)


def test_upwind_slab_grad_matches_jax_grad():
    """The fused gradient (the kernel pair's recompute backward) honors the
    scheme (cross-arm consistency, REQUIREMENT.md:219): loss and gradient
    match jax.grad of the staged loss, and the f64 replica
    (ref/f64_grad.py) finds the fused gradient no farther from the truth
    than jax.grad's own (x1.5). The seed keeps every layer-1
    pre-activation clear of the ReLU kink (tests/helpers.py), where two f32
    arms could pick opposite sides."""
    from helpers import relu_kink_margin

    from phys_autodiff_tpu.models import generate_fields
    from phys_autodiff_tpu.ref.f64_grad import f64_loss_and_grad

    g = GridSpec(scheme="upwind", **GRID)
    w = PhysWeights()
    cfg = MLPGridConfig(dims=MLPDims(H=16))
    params = mlp.init_params(cfg.dims, seed=2)
    assert relu_kink_margin(g, params, 0.25) > 1e-5
    t = jnp.float32(0.25)

    def loss(p):
        return ops.total_loss(g, w, generate_fields(g, cfg, p, t, g.dt))

    l_ref, gp_ref = jax.value_and_grad(loss)(params)
    l_s, gp_s = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(g, w, cfg, p, t, use_fused=True)))(params)
    assert abs(float(l_ref) - float(l_s)) / abs(float(l_ref)) < 5e-6
    _, gp64 = f64_loss_and_grad(g, w, params, 0.25)
    cat = lambda gp: np.concatenate(
        [np.asarray(gp[k], np.float64).ravel() for k in sorted(gp)]
    )
    assert (
        np.linalg.norm(cat(gp_ref) - cat(gp_s)) / np.linalg.norm(cat(gp_ref)) < 1e-4
    )
    dist = lambda gp: np.linalg.norm(cat(gp) - cat(gp64)) / np.linalg.norm(cat(gp64))
    assert dist(gp_s) <= max(1.5 * dist(gp_ref), 1e-6), (dist(gp_s), dist(gp_ref))
