"""The residual stencil the system runs everywhere (ops/, through XLA)
against the f64 oracle over grid x boundary x scheme x field: aligned and
unaligned widths (nx = 127, one short of a 128 multiple, and 128), a
degenerate axis, periodic and clamped boundaries, central and upwind
advection, O(1) random fields (no cancellation: tight 1e-6) and the
manufactured solution 2 of the reference's fused-vs-non-fused test
(float cancellation: the F32_VS_ORACLE ladder)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phys_autodiff_tpu import ops
from phys_autodiff_tpu.ops.stencil import FieldSnapshots
from phys_autodiff_tpu.ref import manufactured, oracle
from phys_autodiff_tpu.utils import tolerances as tol
from phys_autodiff_tpu.utils.config import PhysWeights
from phys_autodiff_tpu.utils.metrics import max_abs_err, rel_l2_err

GRIDS = [(16, 12, 8), (24, 16, 6), (127, 8, 6), (128, 16, 8), (8, 4, 1)]
W = PhysWeights(w_sigma=1.7, w_u=0.9)


def _case(dims, periodic, scheme, kind):
    g = dataclasses.replace(manufactured.periodic_box_spec(*dims),
                            periodic=periodic, scheme=scheme)
    if kind == "sol2":
        return g, manufactured.solution2_fields(g, 0.7)
    rng = np.random.default_rng(sum(dims))
    return g, {
        k: rng.standard_normal(((3,) if k.startswith("u") else ()) + g.shape)
        .astype(np.float32)
        for k in ("sigma_tm1", "sigma_t", "sigma_tp1", "u_tm1", "u_t", "u_tp1")
    }


@pytest.mark.parametrize("dims", GRIDS, ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
@pytest.mark.parametrize("scheme", ["central", "upwind"])
@pytest.mark.parametrize("kind", ["random", "sol2"])
def test_residuals_and_loss_match_oracle(dims, periodic, scheme, kind):
    g, f = _case(dims, periodic, scheme, kind)
    fs = FieldSnapshots(**{k: jnp.asarray(v) for k, v in f.items()})
    rs_ref, ru_ref = oracle.residuals(g, **f)
    rs, ru = jax.jit(lambda x: ops.residuals(g, x))(fs)
    if kind == "random":
        assert rel_l2_err(rs, rs_ref) <= 1e-6
        assert rel_l2_err(ru, ru_ref) <= 1e-6
    else:
        assert rel_l2_err(rs, rs_ref) <= tol.F32_VS_ORACLE_RSIGMA_REL
        assert max_abs_err(rs, rs_ref) <= tol.F32_VS_ORACLE_RSIGMA_MAX
        assert max_abs_err(ru, ru_ref) <= tol.F32_VS_ORACLE_RU_MAX
    # both losses come back rounded to f32: one ulp is their resolution
    for a, b in zip(ops.loss_forward_f64(g, W, fs),
                    oracle.loss_forward(g, W, **f)):
        if float(b) == 0.0:
            assert abs(float(a)) <= 1e-10
        else:
            ulp = float(np.spacing(np.float32(abs(float(b)))))
            assert abs(float(a) - float(b)) <= max(
                tol.LOSS_REL * abs(float(b)), ulp)
