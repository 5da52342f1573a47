"""Parity: the fused training path vs the XLA-staged path.

The fused path generates the fields with the kernel pair of
pallas/fieldgen.py (interpret mode on the CPU backend); the staged path is
models/fields.generate_fields. XLA keeps the residual stencil and the loss
in both, so the arms differ only in how the MLP is evaluated and
differentiated. Port of the reference's fused-vs-nonfused ladder
(test/test_phys_cuda_fused_vs_nonfused.cpp): fields at MLP_INFER_REL; the
loss and gradients of two f32 programs whose reduction orders differ at
the repository's f32-program doctrine (loss 5e-6, global gradient 1e-4,
per-tensor 1e-3 — the finite-difference residual amplifies last-bit field
differences by 1/(2 dt)).

Grids stay tiny (interpret mode is slow) and cover an unaligned, masked
tile tail (12x6x5) and a degenerate axis (nz=1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phys_autodiff_tpu import ops
from phys_autodiff_tpu.models import fields as fields_mod
from phys_autodiff_tpu.models import mlp
from phys_autodiff_tpu.models.coords import _axis_coord
from phys_autodiff_tpu.ops.stencil import FieldSnapshots
from phys_autodiff_tpu.pallas import fieldgen
from phys_autodiff_tpu.train import loop as train_loop
from phys_autodiff_tpu.utils import tolerances as tol
from phys_autodiff_tpu.utils.config import (
    CoordNorm,
    GridSpec,
    MLPDims,
    MLPGridConfig,
    PhysWeights,
)
from phys_autodiff_tpu.utils.metrics import rel_l2_err

GRIDS = {
    "16x8x8": dict(nx=16, ny=8, nz=8),
    "12x6x5": dict(nx=12, ny=6, nz=5),
    "8x4x1": dict(nx=8, ny=4, nz=1),
}
NORMS = [CoordNorm.MinusOneToOne, CoordNorm.ZeroToOne]
W = PhysWeights(w_sigma=1.3, w_u=0.7)


def _grid(name, periodic=True, scheme="central"):
    return GridSpec(**GRIDS[name], hx=0.3, hy=0.35, hz=0.4, dt=1e-2,
                    periodic=periodic, scheme=scheme)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _cat(gp):
    return np.concatenate(
        [np.asarray(gp[k], np.float64).ravel() for k in sorted(gp)]
    )


def _bf16_hand_fields(g, cfg, params, t):
    """The bf16 tier's arithmetic written out: layer 1 in f32, then bf16
    activations and W2 with f32 accumulation."""
    t = jnp.float32(t)
    dt = jnp.float32(g.dt)
    t_off = jnp.float32(0.0 if cfg.norm == CoordNorm.MinusOneToOne else 0.5)
    w1 = params["W1"]
    cx, cy, cz = (_axis_coord(n, cfg.norm) for n in (g.nx, g.ny, g.nz))
    out = []
    for tt in (t - dt, t, t + dt):
        z1 = (cx[None, None, :, None] * w1[0] + cy[None, :, None, None] * w1[1]
              + cz[:, None, None, None] * w1[2]
              + ((t_off + tt) * w1[3] + params["b1"]))
        a1 = jnp.maximum(z1, 0.0).astype(jnp.bfloat16)
        y = jnp.dot(a1, params["W2"].astype(jnp.bfloat16),
                    preferred_element_type=jnp.float32) + params["b2"]
        out.append((y[..., 0], jnp.moveaxis(y[..., 1:4], -1, 0)))
    (s0, u0), (s1, u1), (s2, u2) = out
    return FieldSnapshots(s0, s1, s2, u0, u1, u2)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("norm", NORMS, ids=["m11", "z01"])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("h", [16, 20, 32])
def test_fused_fields_match_plain(grid, norm, precision, h):
    """The pair's fields == the plain generator's in the same tier: f32 at
    MLP_INFER_REL, bf16 (the same bf16-operand arithmetic in XLA) at
    BF16_REL — its distance to the f32 fields is the tier's own class, not
    a fault. H=20 is zero-padded to 32 inside the pair."""
    g = _grid(grid)
    cfg = MLPGridConfig(dims=MLPDims(H=h), norm=norm)
    params = mlp.init_params(cfg.dims, seed=11)
    fs = fieldgen.generate_fields(g, cfg, params, 0.25, g.dt, precision)
    ref = fields_mod.generate_fields(g, cfg, params, 0.25, g.dt, precision)
    bound = tol.MLP_INFER_REL if precision == "f32" else tol.BF16_REL
    for name in fs._fields:
        assert getattr(fs, name).shape == getattr(ref, name).shape, name
        assert rel_l2_err(getattr(fs, name), getattr(ref, name)) <= bound, name


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
@pytest.mark.parametrize("scheme", ["central", "upwind"])
@pytest.mark.parametrize("norm", NORMS, ids=["m11", "z01"])
def test_fused_loss_and_grad_match_staged(grid, periodic, scheme, norm):
    """loss_fn(use_fused=True) and its gradient (params AND t) match
    jax.value_and_grad of the staged loss."""
    g = _grid(grid, periodic, scheme)
    cfg = MLPGridConfig(dims=MLPDims(H=32), norm=norm)
    params = mlp.init_params(cfg.dims, seed=3)
    t = jnp.float32(0.25)

    def arm(use_fused):
        return jax.jit(jax.value_and_grad(
            lambda p, tt: train_loop.loss_fn(g, W, cfg, p, tt, use_fused),
            argnums=(0, 1),
        ))(params, t)

    l_ref, (gp_ref, gt_ref) = arm(False)
    l, (gp, gt) = arm(True)
    assert abs(float(l) - float(l_ref)) / abs(float(l_ref)) < 5e-6
    assert _rel(_cat(gp), _cat(gp_ref)) < 1e-4
    for k in gp_ref:
        assert _rel(gp[k], gp_ref[k]) < 1e-3, k
    assert abs(float(gt) - float(gt_ref)) <= 1e-3 * max(abs(float(gt_ref)), 1e-3)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
def test_fused_bf16_grad_matches_bf16_arithmetic(grid, periodic):
    """The bf16 tier's loss == the same bf16 arithmetic in XLA at BF16_REL
    (both round the same activations to bf16). Their gradients agree only to
    the tier's class: each backward rounds its own cotangent products to
    bf16, and the loss gradient is a cancelling sum, so the bound is 1e-1
    (measured 5e-2 at 16x8x8) — the bf16 tier is a speed tier, not a
    parity arm."""
    g = _grid(grid, periodic)
    cfg = MLPGridConfig(dims=MLPDims(H=32))
    params = mlp.init_params(cfg.dims, seed=4)

    def fused(p):
        return ops.total_loss(
            g, W, fieldgen.generate_fields(g, cfg, p, 0.25, g.dt, "bf16"))

    def plain(p):
        return ops.total_loss(
            g, W, fields_mod.generate_fields(g, cfg, p, 0.25, g.dt, "bf16"))

    l, gp = jax.jit(jax.value_and_grad(fused))(params)
    l_ref, gp_ref = jax.jit(jax.value_and_grad(plain))(params)
    assert abs(float(l) - float(l_ref)) / abs(float(l_ref)) < tol.BF16_REL
    assert _rel(_cat(gp), _cat(gp_ref)) < 1e-1


@pytest.mark.parametrize("norm", NORMS, ids=["m11", "z01"])
def test_plain_bf16_tier_is_the_written_out_arithmetic(norm):
    """models/fields.generate_fields(precision="bf16") is layer 1 in f32
    and layer 2 on bf16 operands with f32 accumulation; the two sum layer 1
    in different orders, so a bf16 rounding can differ: BF16_REL."""
    g = _grid("12x6x5")
    cfg = MLPGridConfig(dims=MLPDims(H=32), norm=norm)
    params = mlp.init_params(cfg.dims, seed=12)
    fs = fields_mod.generate_fields(g, cfg, params, 0.25, g.dt, "bf16")
    ref = _bf16_hand_fields(g, cfg, params, 0.25)
    for name in fs._fields:
        assert rel_l2_err(getattr(fs, name), getattr(ref, name)) <= tol.BF16_REL, name


def test_plain_generator_rejects_unknown_precision():
    g = _grid("8x4x1")
    cfg = MLPGridConfig(dims=MLPDims(H=16))
    with pytest.raises(ValueError, match="precision"):
        fields_mod.generate_fields(g, cfg, mlp.init_params(cfg.dims), 0.25,
                                   g.dt, "f32_high")


@pytest.mark.parametrize("n", [1, 63, 64, 65, 1536, 65536, 1179648, 4718592])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_backward_launch_plan_covers_every_tile_once(n, precision):
    """Each backward program walks `tiles` consecutive tiles: together they
    cover every tile of the grid, no program is wholly past the end, and
    there are at most _MAX_PROGRAMS partial blocks for XLA to sum."""
    block, _ = fieldgen._TILING[precision]
    n_tiles = -(-n // block)
    tiles, programs = fieldgen._launch_plan(n, block)
    assert programs * tiles >= n_tiles
    assert (programs - 1) * tiles < n_tiles
    assert programs <= fieldgen._MAX_PROGRAMS


@pytest.mark.parametrize("h, hp", [(1, 16), (4, 16), (16, 16), (17, 32),
                                   (20, 32), (64, 64), (100, 128),
                                   (128, 128), (129, 256)])
def test_hidden_width_pads_to_a_power_of_two(h, hp):
    assert fieldgen._hidden_pad(h) == hp


def test_tiling_is_triton_legal():
    for precision, (block, warps) in fieldgen._TILING.items():
        assert block & (block - 1) == 0 and block >= 16, precision
        assert warps & (warps - 1) == 0, precision


def test_fused_train_step_matches_staged():
    """TrainConfig(use_fused=True) trains the same trajectory as the staged
    step (loss history within 1e-4 relative at every logged step)."""
    g = _grid("16x8x8")
    mcfg = MLPGridConfig(dims=MLPDims(H=16))
    hists = {}
    for fused in (False, True):
        cfg = train_loop.TrainConfig(
            use_fused=fused, steps=15, learning_rate=3e-3, log_every=5
        )
        _, hist, _ = train_loop.fit(g, W, mcfg, cfg)
        hists[fused] = hist
    for (s0, l0), (s1, l1) in zip(hists[False], hists[True]):
        assert s0 == s1
        assert abs(l0 - l1) / max(abs(l0), 1e-12) < 1e-4
    assert hists[True][-1][1] < hists[True][0][1]


def test_fused_scan_epoch_matches_step_loop():
    """The scan-based epoch (fit_scan's production shape) runs the fused
    step too, with the same losses as the step-at-a-time loop."""
    g = _grid("12x6x5")
    mcfg = MLPGridConfig(dims=MLPDims(H=16))
    cfg = train_loop.TrainConfig(use_fused=True, steps=6, log_every=3)
    _, hist, _ = train_loop.fit(g, W, mcfg, cfg)
    _, hist_scan, _ = train_loop.fit_scan(g, W, mcfg, cfg)
    assert [s for s, _ in hist_scan] == [3, 6]
    assert abs(hist_scan[-1][1] - hist[-1][1]) <= 1e-5 * abs(hist[-1][1])


def test_fused_upwind_differs_from_central():
    """The scheme reaches the fused path (a wrong plumbing would make the
    upwind loss equal the central one)."""
    cfg = MLPGridConfig(dims=MLPDims(H=16))
    params = mlp.init_params(cfg.dims, seed=2)
    losses = [
        float(train_loop.loss_fn(_grid("16x8x8", scheme=s), W, cfg, params,
                                 0.25, True))
        for s in ("central", "upwind")
    ]
    assert abs(losses[0] - losses[1]) > 1e-6 * abs(losses[0])


def test_fused_remat_flag_is_ignored_by_fused_path():
    """remat only rewires the plain generator; the fused path already
    recomputes, so its loss does not depend on the flag."""
    g = _grid("8x4x1")
    cfg = MLPGridConfig(dims=MLPDims(H=16))
    params = mlp.init_params(cfg.dims, seed=6)
    a = train_loop.loss_fn(g, W, cfg, params, 0.25, True, remat=False)
    b = train_loop.loss_fn(g, W, cfg, params, 0.25, True, remat=True)
    assert float(a) == float(b)


def test_fused_fields_are_deterministic():
    """Fixed-order partial sums: two runs of the backward are bitwise
    equal."""
    g = _grid("12x6x5")
    cfg = MLPGridConfig(dims=MLPDims(H=16))
    params = mlp.init_params(cfg.dims, seed=8)
    f = jax.jit(jax.grad(lambda p: train_loop.loss_fn(g, W, cfg, p, 0.25, True)))
    a, b = f(params), f(params)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.mark.parametrize("h", [20, 48])
def test_fused_pads_hidden_width(h):
    """A hidden width that is not a power of two is zero-padded inside the
    pair; the padded units carry no value and no gradient."""
    g = _grid("12x6x5")
    cfg = MLPGridConfig(dims=MLPDims(H=h))
    params = mlp.init_params(cfg.dims, seed=9)
    l, gp = jax.value_and_grad(
        lambda p: train_loop.loss_fn(g, W, cfg, p, 0.25, True))(params)
    l_ref, gp_ref = jax.value_and_grad(
        lambda p: train_loop.loss_fn(g, W, cfg, p, 0.25, False))(params)
    assert abs(float(l) - float(l_ref)) / abs(float(l_ref)) < 5e-6
    for k in gp_ref:
        assert gp[k].shape == gp_ref[k].shape
    assert _rel(_cat(gp), _cat(gp_ref)) < 1e-4


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
def test_fused_rows_match_full_generation(periodic):
    """z_idx generates exactly the requested global rows (the sharded
    step's shard rows plus recomputed halos)."""
    g = dataclasses.replace(_grid("12x6x5"), periodic=periodic)
    cfg = MLPGridConfig(dims=MLPDims(H=16))
    params = mlp.init_params(cfg.dims, seed=10)
    rows = np.arange(-1, 4)
    rows = np.mod(rows, g.nz) if periodic else np.clip(rows, 0, g.nz - 1)
    full = fieldgen.generate_fields(g, cfg, params, 0.25)
    part = fieldgen.generate_fields(g, cfg, params, 0.25, z_idx=jnp.asarray(rows))
    np.testing.assert_array_equal(np.asarray(part.sigma_t),
                                  np.asarray(full.sigma_t)[rows])
    np.testing.assert_array_equal(np.asarray(part.u_tp1),
                                  np.asarray(full.u_tp1)[:, rows])


def test_fused_rejects_unknown_precision():
    g = _grid("8x4x1")
    cfg = MLPGridConfig(dims=MLPDims(H=16))
    with pytest.raises(ValueError, match="precision"):
        fieldgen.generate_fields(g, cfg, mlp.init_params(cfg.dims), 0.25,
                                 precision="f32_high")
