"""The kernel pair (pallas/fieldgen.py) compiled for the card, against the
plain generator (models/fields.py) on the shapes its CPU tests cover in
interpret mode: a masked tile tail, a degenerate axis, hidden widths that
need padding, both coordinate norms, shard rows, both precision tiers.

Marked `gpu`: they skip on the CPU and run on an NVIDIA GPU through
chip_smoke.py (PHYS_AUTODIFF_TEST_GPU=1, see conftest.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from helpers import relu_kink_margin

from phys_autodiff_tpu import ops
from phys_autodiff_tpu.models import fields as fields_mod
from phys_autodiff_tpu.models import mlp
from phys_autodiff_tpu.pallas import fieldgen
from phys_autodiff_tpu.utils import tolerances as tol
from phys_autodiff_tpu.utils.config import (
    CoordNorm,
    GridSpec,
    MLPDims,
    MLPGridConfig,
    PhysWeights,
)
from phys_autodiff_tpu.utils.metrics import rel_l2_err

pytestmark = pytest.mark.gpu

GRIDS = {"64x48x32": (64, 48, 32), "12x6x5": (12, 6, 5), "8x4x1": (8, 4, 1)}


def _setup(grid, h=32, norm=CoordNorm.MinusOneToOne, seed=2):
    nx, ny, nz = GRIDS[grid]
    g = GridSpec(nx=nx, ny=ny, nz=nz, hx=0.3, hy=0.35, hz=0.4, dt=1e-2)
    cfg = MLPGridConfig(dims=MLPDims(H=h), norm=norm)
    return g, cfg, mlp.init_params(cfg.dims, seed=seed)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("h", [20, 128])
@pytest.mark.parametrize("norm", [CoordNorm.MinusOneToOne, CoordNorm.ZeroToOne],
                         ids=["m11", "z01"])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_compiled_fields_match_plain(gpu, grid, h, norm, precision):
    g, cfg, params = _setup(grid, h, norm)
    fs = jax.jit(lambda p: fieldgen.generate_fields(
        g, cfg, p, 0.25, g.dt, precision))(params)
    ref = jax.jit(lambda p: fields_mod.generate_fields(
        g, cfg, p, 0.25, g.dt, precision))(params)
    bound = tol.MLP_INFER_REL if precision == "f32" else tol.BF16_REL
    for a, b in zip(fs, ref):
        assert a.shape == b.shape
        assert rel_l2_err(a, b) <= bound


@pytest.mark.parametrize("grid", list(GRIDS))
def test_compiled_grad_matches_jax_grad(gpu, grid):
    g, cfg, params = _setup(grid)
    if g.num_cells < 1000:
        # few cells: one unit flipped at the ReLU kink would dominate; at
        # 64x48x32 kinks are certain but each is one cell in 98,304
        assert relu_kink_margin(g, params, 0.25) > 1e-5
    w = PhysWeights(w_sigma=1.3, w_u=0.7)

    def arm(gen):
        return jax.jit(jax.value_and_grad(
            lambda p: ops.total_loss(g, w, gen(p))))(params)

    l, gp = arm(lambda p: fieldgen.generate_fields(g, cfg, p, 0.25, g.dt))
    l_ref, gp_ref = arm(
        lambda p: fields_mod.generate_fields(g, cfg, p, 0.25, g.dt))
    assert abs(float(l) - float(l_ref)) / abs(float(l_ref)) < 5e-6
    cat = lambda d: np.concatenate(
        [np.asarray(d[k], np.float64).ravel() for k in sorted(d)])
    assert np.linalg.norm(cat(gp) - cat(gp_ref)) <= 1e-4 * np.linalg.norm(cat(gp_ref))


def test_compiled_rows_and_determinism(gpu):
    g, cfg, params = _setup("64x48x32")
    rows = jnp.asarray(np.mod(np.arange(7, 17), g.nz))
    full = fieldgen.generate_fields(g, cfg, params, 0.25)
    part = fieldgen.generate_fields(g, cfg, params, 0.25, z_idx=rows)
    np.testing.assert_array_equal(np.asarray(part.sigma_t),
                                  np.asarray(full.sigma_t)[np.asarray(rows)])
    grad = jax.jit(jax.grad(lambda p: ops.total_loss(
        g, PhysWeights(), fieldgen.generate_fields(g, cfg, p, 0.25))))
    a, b = grad(params), grad(params)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
