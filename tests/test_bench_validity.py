"""The benchmark harness's DCE-validity machinery (bench/harness.py).

A timed body that XLA narrows by dead-code elimination measures less than
the op. These tests pin the defenses, including a NEGATIVE control: a
naive timing body (consume one element of one output) measurably LOSES
the full-shape computation in the optimized HLO, while the
generational-feedback body retains it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phys_autodiff_tpu import ops
from phys_autodiff_tpu.bench import harness
from phys_autodiff_tpu.utils.config import GridSpec


def _grid():
    return GridSpec(nx=32, ny=16, nz=8, hx=0.3, hy=0.3, hz=0.3, dt=1e-2)


def test_feedback_mode_retains_full_shapes():
    g = _grid()
    fs = harness.random_fields(g)
    txt = harness.check_timed_hlo(
        lambda f: ops.residuals(g, f),
        None,
        ["f32[8,16,32]", "f32[3,8,16,32]"],
        mode="feedback",
        fields=fs,
    )
    assert "while" in txt  # the timed fori_loop survived as a while loop


def test_negative_control_round1_body_is_dced():
    """The failure mode reproduced: a body that consumes one element
    of one output lets XLA narrow the staged stencil — the full-shape R_u
    tensor disappears from the optimized HLO. (This is exactly why probe
    mode is reserved for opaque Pallas calls.)"""
    g = _grid()
    fs = harness.random_fields(g)

    def body(i, carry):
        acc, s = carry
        s2 = s.at[0, 0, 0].add(acc * 1e-30)
        rs, ru = ops.residuals(g, fs._replace(sigma_t=s2))
        return acc + rs.reshape(-1)[0], s

    run = harness._make_run(body)
    txt = run.lower((jnp.float32(0.0), fs.sigma_t), jnp.int32(4)).compile().as_text()
    # r_u [3, nz, ny, nx] is never consumed: its full shape must be gone
    assert "f32[3,8,16,32]" not in txt


def test_time_loop_measures_positive_slope():
    g = _grid()
    fs = harness.random_fields(g)
    ms = harness.time_residual_op(lambda x: ops.residuals(g, x), fs)
    assert 0.0 < ms < 1e3


def test_feedback_values_stay_finite():
    """The carried epsilon damps the feedback so long runs neither overflow
    nor produce NaNs (values may decay to zero, which is fine for timing)."""
    g = _grid()
    fs = harness.random_fields(g)
    body = harness._residual_feedback_body(lambda f: ops.residuals(g, f))
    run = harness._make_run(body)
    out = run(harness._residual_feedback_carry(fs), jnp.int32(50))
    for leaf in jax.tree_util.tree_leaves(out):
        assert bool(jnp.all(jnp.isfinite(leaf)))
