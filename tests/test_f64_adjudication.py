"""f64 adjudication of the fused path's gradients.

The fused training path (fields from the kernel pair of
pallas/fieldgen.py) and jax.grad of the staged path are two FLOAT32
implementations of the same exact-arithmetic function. In clamp mode that
comparison is ill-conditioned: the loss is small and the gradient
contributions nearly cancel, so both arms can sit ~1e-3 from the TRUE
gradient while agreeing with each other only to a few 1e-4. These tests
referee the gap with ref/f64_grad (an independent float64 replica
differentiated in x64): the fused arm passes if its distance to the truth
is no worse than jax.grad's own (x a small slack), which is the strongest
correctness statement available to any f32 implementation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phys_autodiff_tpu import ops
from phys_autodiff_tpu.models import fields as fields_mod
from phys_autodiff_tpu.models import mlp
from phys_autodiff_tpu.train.loop import loss_fn
from phys_autodiff_tpu.ref.f64_grad import f64_loss_and_grad
from phys_autodiff_tpu.utils.config import (
    CoordNorm,
    GridSpec,
    MLPDims,
    MLPGridConfig,
    PhysWeights,
)

W = PhysWeights(w_sigma=1.3, w_u=0.7)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _cat(gp):
    return np.concatenate(
        [np.asarray(gp[k], np.float64).ravel() for k in sorted(gp)]
    )


@pytest.mark.parametrize(
    "spec", [(16, 8, 8), (12, 6, 5)], ids=["16x8x8", "12x6x5"]
)
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
@pytest.mark.parametrize("scheme", ["central", "upwind"])
@pytest.mark.parametrize(
    "norm", [CoordNorm.MinusOneToOne, CoordNorm.ZeroToOne], ids=["m11", "z01"]
)
def test_fused_no_worse_than_jax_grad_vs_f64_truth(spec, periodic, scheme, norm):
    nx, ny, nz = spec
    g = GridSpec(
        nx=nx, ny=ny, nz=nz, hx=1.0 / nx, hy=1.0 / ny, hz=1.0 / nz,
        dt=1e-3, periodic=periodic, scheme=scheme,
    )
    cfg = MLPGridConfig(dims=MLPDims(H=32), norm=norm)
    params = mlp.init_params(cfg.dims, seed=777)
    t = 0.25

    l64, gp64 = f64_loss_and_grad(g, W, params, t, norm=norm)

    def arm(use_fused):
        return jax.jit(jax.value_and_grad(
            lambda p, tt: loss_fn(g, W, cfg, p, tt, use_fused)
        ))(params, jnp.float32(t))

    l32, gp32 = arm(False)
    lk, gpk = arm(True)

    # losses: both f32 arms within the f32 noise floor of the truth. The
    # floor is set by the time difference: a last-bit field difference
    # (the arms associate layer 1 differently) is amplified by
    # 1/(2 dt) = 500, measured up to 1.6e-5 relative on these grids while
    # the staged arm can land by chance within 3e-8.
    staged_loss_err = abs(float(l32) - l64) / abs(l64)
    kernel_loss_err = abs(float(lk) - l64) / abs(l64)
    assert kernel_loss_err <= max(5.0 * staged_loss_err, 3e-5)

    # gradients: the kernel's distance to the f64 truth is no worse than
    # jax.grad's own distance (x1.5 slack for association differences)
    d_jax = _rel(_cat(gp32), _cat(gp64))
    d_kernel = _rel(_cat(gpk), _cat(gp64))
    assert d_kernel <= max(1.5 * d_jax, 1e-6), (d_kernel, d_jax)
    for k in sorted(gp64):
        assert _rel(gpk[k], gp64[k]) <= max(2.0 * _rel(gp32[k], gp64[k]), 1e-6), k


def test_f64_oracle_zero_to_one_norm():
    """The referee must grade the function the pipeline actually evaluates:
    with norm=ZeroToOne (u in [0,1] coords + the reference's t+0.5 time
    quirk) the f64 oracle sits at f32 distance from jax.grad of the
    ZeroToOne staged pipeline, while the MinusOneToOne referee is orders of
    magnitude off — passing the wrong norm is a graded-wrong-function
    hazard, not a tolerance detail."""
    from phys_autodiff_tpu.utils.config import CoordNorm

    g = GridSpec(nx=16, ny=12, nz=6, hx=1 / 16, hy=1 / 12, hz=1 / 6, dt=1e-3)
    cfg = MLPGridConfig(dims=MLPDims(H=24), norm=CoordNorm.ZeroToOne)
    params = mlp.init_params(cfg.dims, seed=5)
    t = 0.3

    def staged_total(p, tt):
        return ops.total_loss(
            g, W, fields_mod.generate_fields(g, cfg, p, tt, g.dt)
        )

    l32, gp32 = jax.jit(jax.value_and_grad(staged_total))(
        params, jnp.float32(t)
    )
    l64, gp64 = f64_loss_and_grad(g, W, params, t, norm=CoordNorm.ZeroToOne)
    assert abs(float(l32) - l64) / abs(l64) < 1e-4
    assert _rel(_cat(gp32), _cat(gp64)) < 1e-4

    # the wrong-norm referee grades a different function entirely
    l64_wrong, gp64_wrong = f64_loss_and_grad(g, W, params, t)
    assert abs(float(l32) - l64_wrong) / abs(l64_wrong) > 1e-2
    assert _rel(_cat(gp32), _cat(gp64_wrong)) > 1e-2
