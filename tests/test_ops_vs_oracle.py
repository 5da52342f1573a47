"""Tier-2 parity: XLA-staged f32 ops path vs the f64 oracle.

Port of test/test_phys_cuda_nonfused_vs_cpu.cpp — the float device arm vs the
double host arm on manufactured solution 1: R_sigma to 3e-4/1e-3 (float
cancellation headroom in the time difference), R_u and backward to 1e-7/1e-6,
plus the jax.grad-vs-hand-VJP cross-check the reference could never do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phys_autodiff_tpu import ops
from phys_autodiff_tpu.ops.stencil import FieldSnapshots
from phys_autodiff_tpu.ref import manufactured, oracle
from phys_autodiff_tpu.utils import tolerances as tol
from phys_autodiff_tpu.utils.config import GridSpec, PhysWeights
from phys_autodiff_tpu.utils.metrics import max_abs_err, rel_l2_err

T0 = 1.2345


def _snapshots(f) -> FieldSnapshots:
    return FieldSnapshots(**{k: jnp.asarray(v) for k, v in f.items()})


@pytest.fixture(scope="module")
def sol1():
    g = manufactured.periodic_box_spec()
    f = manufactured.solution1_fields(g, T0)
    return g, f


def test_residuals_parity(sol1):
    g, f = sol1
    r_sigma_ref, r_u_ref = oracle.residuals(g, **f)
    r_sigma, r_u = jax.jit(lambda fs: ops.residuals(g, fs))(_snapshots(f))

    assert rel_l2_err(r_sigma, r_sigma_ref) <= tol.F32_VS_ORACLE_RSIGMA_REL
    assert max_abs_err(r_sigma, r_sigma_ref) <= tol.F32_VS_ORACLE_RSIGMA_MAX
    assert rel_l2_err(r_u, r_u_ref) <= tol.F32_VS_ORACLE_RU_REL or np.max(
        np.abs(np.asarray(r_u_ref))
    ) == 0.0
    assert max_abs_err(r_u, r_u_ref) <= tol.F32_VS_ORACLE_RU_MAX


def test_clamp_boundary_parity():
    """Non-periodic clamp boundaries must match the oracle exactly in f32."""
    rng = np.random.default_rng(7)
    g = GridSpec(nx=16, ny=12, nz=8, hx=0.3, hy=0.4, hz=0.5, dt=0.01, periodic=False)
    f = dict(
        sigma_tm1=rng.standard_normal(g.shape).astype(np.float32),
        sigma_t=rng.standard_normal(g.shape).astype(np.float32),
        sigma_tp1=rng.standard_normal(g.shape).astype(np.float32),
        u_tm1=rng.standard_normal((3,) + g.shape).astype(np.float32),
        u_t=rng.standard_normal((3,) + g.shape).astype(np.float32),
        u_tp1=rng.standard_normal((3,) + g.shape).astype(np.float32),
    )
    r_sigma_ref, r_u_ref = oracle.residuals(g, **f)
    r_sigma, r_u = jax.jit(lambda fs: ops.residuals(g, fs))(_snapshots(f))
    # random O(1) fields, no cancellation: tight tolerance on everything
    assert rel_l2_err(r_sigma, r_sigma_ref) <= 1e-6
    assert rel_l2_err(r_u, r_u_ref) <= 1e-6


def test_loss_forward_parity(sol1):
    g, f = sol1
    w = PhysWeights(w_sigma=1.7, w_u=0.9)
    ls_ref, lu_ref = oracle.loss_forward(g, w, **f)
    ls, lu = ops.loss_forward_f64(g, w, _snapshots(f))
    assert abs(float(ls) - float(ls_ref)) / abs(float(ls_ref)) <= tol.LOSS_REL
    assert abs(float(lu) - float(lu_ref)) <= 1e-10  # both ~0

    # On-device f32 reduction: looser bound — the CPU backend reduces f32
    # sums sequentially. The 1e-7 doctrine is carried by the f64 arm above.
    ls32, lu32 = jax.jit(lambda fs: ops.loss_forward(g, w, fs))(_snapshots(f))
    assert abs(float(ls32) - float(ls_ref)) / abs(float(ls_ref)) <= 1e-4


def test_hand_vjp_parity(sol1):
    g, f = sol1
    w = PhysWeights(w_sigma=1.7, w_u=0.9)
    r_sigma_ref, r_u_ref = oracle.residuals(g, **f)
    gs_ref, gu_ref = oracle.loss_backward(g, w, r_sigma_ref, r_u_ref)

    r_sigma, r_u = jax.jit(lambda fs: ops.residuals(g, fs))(_snapshots(f))
    gs, gu = jax.jit(lambda rs, ru: ops.loss_backward(g, w, rs, ru))(r_sigma, r_u)
    assert rel_l2_err(gs, gs_ref) <= tol.F32_VS_ORACLE_RU_REL
    assert max_abs_err(gs, gs_ref) <= tol.F32_VS_ORACLE_RU_MAX
    assert max_abs_err(gu, gu_ref) <= tol.F32_VS_ORACLE_RU_MAX


def test_jax_grad_matches_hand_vjp(sol1):
    """jax.grad of the loss w.r.t. the RESIDUALS equals the hand VJP
    g = 2wR/N — the autodiff cross-check (new capability, no reference
    analogue)."""
    g, f = sol1
    w = PhysWeights(w_sigma=1.3, w_u=0.8)
    r_sigma, r_u = ops.residuals(g, _snapshots(f))

    def loss_of_r(rs, ru):
        ls, lu = ops.loss_terms(g, w, rs, ru)
        return ls + lu

    gs_auto, gu_auto = jax.jit(jax.grad(loss_of_r, argnums=(0, 1)))(r_sigma, r_u)
    gs_hand, gu_hand = ops.loss_backward(g, w, r_sigma, r_u)
    assert rel_l2_err(gs_auto, gs_hand) <= 1e-6
    assert rel_l2_err(gu_auto, gu_hand) <= 1e-6


def test_field_adjoint_finite_difference():
    """jax.grad through the full residual stencil (the field adjoint the
    reference lacks) against a central finite-difference probe."""
    rng = np.random.default_rng(3)
    g = GridSpec(nx=8, ny=8, nz=8, hx=0.7, hy=0.6, hz=0.5, dt=0.05, periodic=True)
    w = PhysWeights(w_sigma=1.0, w_u=1.0)
    f = {
        k: rng.standard_normal(
            ((3,) + g.shape) if k.startswith("u") else g.shape
        ).astype(np.float32)
        for k in ["sigma_tm1", "sigma_t", "sigma_tp1", "u_tm1", "u_t", "u_tp1"]
    }
    fs = _snapshots(f)

    def loss(fields):
        return ops.total_loss(g, w, fields)

    grads = jax.jit(jax.grad(loss))(fs)

    # probe d loss / d sigma_t[2,3,4] by central difference in f64
    eps = 1e-3
    idx = (2, 3, 4)

    def loss64(delta):
        f2 = dict(f)
        st = f2["sigma_t"].copy()
        st[idx] += delta
        f2["sigma_t"] = st
        ls, lu, r_s, r_u = oracle.loss_forward(
            g, w, **f2, return_residuals=True
        )
        # recompute loss in f64 from residuals for a smooth probe
        n = g.num_cells
        return float(
            np.sum(np.asarray(r_s, np.float64) ** 2) / n
            + np.sum(np.asarray(r_u, np.float64) ** 2) / n
        )

    fd = (loss64(eps) - loss64(-eps)) / (2 * eps)
    ad = float(grads.sigma_t[idx])
    assert abs(ad - fd) <= 5e-4 * max(1.0, abs(fd))
