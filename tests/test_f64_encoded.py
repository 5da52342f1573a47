"""f64 adjudication of the ENCODED-family gradients.

The NGP and Fourier training steps take jax.value_and_grad through the XLA
pipeline (encoder -> decode head -> residuals -> loss). An independent
float64 replica of that chain (ref/f64_grad.f64_encoded_loss_and_grad)
grades the f32 gradient: it must sit within the f32 noise class of the
truth, for both schemes, both encoder families and both boundary modes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phys_autodiff_tpu import ops
from phys_autodiff_tpu.models import ngp
from phys_autodiff_tpu.ref.f64_grad import f64_encoded_loss_and_grad
from phys_autodiff_tpu.utils.config import GridSpec, PhysWeights

W = PhysWeights(w_sigma=1.3, w_u=0.7)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _cat(gp):
    return np.concatenate(
        [np.asarray(x, np.float64).ravel() for x in jax.tree_util.tree_leaves(gp)]
    )


def _conditioned_params(ncfg, seed=777):
    """Paper-init tables leave every gradient at the f32 noise floor where
    relative comparison is meaningless: scale the tables up and give the
    head nonzero biases."""
    params = ngp.init_ngp_params(ncfg, seed=seed)
    rng = np.random.Generator(np.random.MT19937(21))
    params["tables"] = jax.tree_util.tree_map(
        lambda a: a * 2000.0, params["tables"]
    )
    params["b1"] = jnp.asarray(
        rng.standard_normal(params["b1"].shape) * 0.3, jnp.float32
    )
    params["b2"] = jnp.asarray(
        rng.standard_normal(params["b2"].shape) * 0.3, jnp.float32
    )
    return params


def _adjudicate(g, ncfg, params, t=0.25):
    """(loss_err, grad_err) of the f32 training gradient (jax.value_and_grad
    through ngp.generate_fields, the NGP step's arm) against the f64
    truth."""
    l64, gp64 = f64_encoded_loss_and_grad(g, W, ncfg, params, t)

    def staged_total(p, tt):
        fs = ngp.generate_fields(g, ncfg, p, tt, g.dt)
        return ops.total_loss(g, W, fs)

    l32, gp32 = jax.jit(jax.value_and_grad(staged_total))(params, jnp.float32(t))
    return abs(float(l32) - l64) / abs(l64), _rel(_cat(gp32), _cat(gp64))


@pytest.mark.parametrize("scheme", ["central", "upwind"])
@pytest.mark.parametrize("periodic", [True, False])
def test_ngp_grad_vs_f64_truth(scheme, periodic):
    """Measured truth distances of the f32 gradient: 2e-6..1e-5 across the
    four (scheme, boundary) configs at 32x16x8 (the f32 noise class)."""
    g = GridSpec(
        nx=32, ny=16, nz=8, hx=1 / 32, hy=1 / 16, hz=1 / 8, dt=1e-3,
        periodic=periodic, scheme=scheme,
    )
    ncfg = ngp.NGPFieldConfig()
    loss_err, grad_err = _adjudicate(g, ncfg, _conditioned_params(ncfg))
    assert loss_err < 1e-4, loss_err
    assert grad_err < 1e-4, grad_err


def test_fourier_grad_vs_f64_truth():
    from phys_autodiff_tpu.models.fourier import FourierEncodingConfig

    g = GridSpec(nx=32, ny=16, nz=8, hx=1 / 32, hy=1 / 16, hz=1 / 8, dt=1e-3)
    ncfg = ngp.NGPFieldConfig(encoding=FourierEncodingConfig())
    params = ngp.init_ngp_params(ncfg, seed=777)
    rng = np.random.Generator(np.random.MT19937(21))
    params["b1"] = jnp.asarray(
        rng.standard_normal(params["b1"].shape) * 0.3, jnp.float32
    )
    params["b2"] = jnp.asarray(
        rng.standard_normal(params["b2"].shape) * 0.3, jnp.float32
    )
    loss_err, grad_err = _adjudicate(g, ncfg, params)
    assert loss_err < 1e-4, loss_err
    assert grad_err < 1e-4, grad_err


def test_f64_encoded_referee_grades_the_right_function():
    """Control: the referee's loss must match the staged f32 arm to f32
    rounding, and a DIFFERENT encoding schedule must not (the graded-wrong-
    function hazard, mirroring test_f64_oracle_zero_to_one_norm)."""
    from phys_autodiff_tpu.models.hash_encoder import HashEncodingConfig

    g = GridSpec(nx=16, ny=12, nz=6, hx=1 / 16, hy=1 / 12, hz=1 / 6, dt=1e-3)
    ncfg = ngp.NGPFieldConfig()
    params = _conditioned_params(ncfg, seed=5)
    l64, _ = f64_encoded_loss_and_grad(g, W, ncfg, params, 0.3)

    def staged_total(p):
        fs = ngp.generate_fields(g, ncfg, p, 0.3, g.dt)
        return ops.total_loss(g, W, fs)

    l32 = float(jax.jit(staged_total)(params))
    assert abs(l32 - l64) / abs(l64) < 1e-4

    # wrong schedule: fewer levels -> different function (params sliced to
    # the smaller config would be required; instead check the schedule
    # mismatch is structural — the referee refuses mismatched tables)
    ncfg_wrong = ngp.NGPFieldConfig(
        encoding=HashEncodingConfig(num_levels=4, dense_oversubscribed=True)
    )
    with pytest.raises(Exception):
        f64_encoded_loss_and_grad(g, W, ncfg_wrong, params, 0.3)
