"""Fourier-feature encoded field model (models/fourier.py + the
models/encoders dispatch): the second extension encoder family. The same
decode head, training step and sharded step must serve it unchanged — that
interchangeability is the framework-generality contract under test. No
reference analogue (the reference has exactly one model family,
SURVEY.md §0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phys_autodiff_tpu import ops
from phys_autodiff_tpu.models import encoders, fourier, ngp
from phys_autodiff_tpu.models.fourier import FourierEncodingConfig
from phys_autodiff_tpu.utils.config import GridSpec, PhysWeights

ENC = FourierEncodingConfig(num_frequencies=2, include_input=True)  # LF=15


def _setup(nx=128, ny=8, nz=6, periodic=True, scheme="central", hidden=16):
    g = GridSpec(nx=nx, ny=ny, nz=nz, hx=0.3, hy=0.3, hz=0.3, dt=1e-2,
                 periodic=periodic, scheme=scheme)
    ncfg = ngp.NGPFieldConfig(encoding=ENC, hidden=hidden)
    params = ngp.init_ngp_params(ncfg, seed=7)
    rng = np.random.Generator(np.random.MT19937(21))
    params["b1"] = jnp.asarray(
        rng.standard_normal(params["b1"].shape) * 0.3, jnp.float32
    )
    params["b2"] = jnp.asarray(
        rng.standard_normal(params["b2"].shape) * 0.3, jnp.float32
    )
    w = PhysWeights(w_sigma=1.3, w_u=0.7)
    return g, w, ncfg, params


def _staged_total(g, w, ncfg, params, t):
    fs = ngp.generate_fields(g, ncfg, params, t, g.dt)
    ls, lu = ops.loss_forward(g, w, fs)
    return ls + lu


def _leaf_close(a, b, tol):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) <= tol * max(np.linalg.norm(a), 1e-30)


def test_encode_matches_numpy_oracle():
    """Channel order and values vs an independent NumPy evaluation:
    per axis (x, y, z): [v, sin(pi 2^k v), cos(pi 2^k v) for k < K]."""
    cfg = FourierEncodingConfig(num_frequencies=3, include_input=True)
    rng = np.random.Generator(np.random.MT19937(5))
    pts = rng.uniform(0.0, 1.0, (11, 3)).astype(np.float32)
    out = np.asarray(fourier.encode(cfg, jnp.asarray(pts)))
    assert out.shape == (11, cfg.out_dim)
    ref_cols = []
    for a in range(3):
        v = pts[:, a].astype(np.float64)
        ref_cols.append(v)
        for k in range(3):
            w = np.float32(np.pi * 2.0**k).astype(np.float64)
            ref_cols.append(np.sin(w * v))
            ref_cols.append(np.cos(w * v))
    ref = np.stack(ref_cols, axis=-1)
    # f32 w*v product rounding: |arg| <= 4pi -> ~1.5e-6 arg error max
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-6)


def test_encode_no_input_channel_dim():
    cfg = FourierEncodingConfig(num_frequencies=4, include_input=False)
    assert cfg.out_dim == 3 * 8
    out = fourier.encode(cfg, jnp.zeros((2, 3), jnp.float32))
    assert out.shape == (2, 24)


def test_encode_grid_bit_identical_to_pointwise():
    """The broadcast grid path must equal the pointwise path EXACTLY (the
    same f32 coordinates feed the same sin/cos)."""
    g, _, ncfg, _ = _setup(nx=12, ny=7, nz=5)
    coords = ngp._unit_coords(g)
    ref = np.asarray(fourier.encode(ENC, coords))
    out = np.asarray(fourier.encode_grid(ENC, g))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("dims", [(12, 7, 1), (1, 5, 4), (9, 1, 3)],
                         ids=["nz1", "nx1", "ny1"])
def test_encode_grid_degenerate_axes(dims):
    """A degenerate axis takes coordinate 0 in both paths; the grid path
    stays bit-identical to the pointwise one."""
    g, _, _, _ = _setup(nx=dims[0], ny=dims[1], nz=dims[2])
    out = np.asarray(fourier.encode_grid(ENC, g))
    assert out.shape == (dims[2], dims[1], dims[0], ENC.out_dim)
    np.testing.assert_array_equal(
        out, np.asarray(fourier.encode(ENC, ngp._unit_coords(g))))


def test_encoders_dispatch():
    """The dispatch layer routes both families and rejects unknowns."""
    from phys_autodiff_tpu.models.hash_encoder import HashEncodingConfig

    hcfg = HashEncodingConfig(num_levels=2, base_resolution=4,
                              max_resolution=8, log2_table_size=7)
    assert encoders.out_dim(hcfg) == hcfg.out_dim
    assert encoders.out_dim(ENC) == ENC.out_dim
    assert encoders.init_params(ENC).size == 0
    assert encoders.schedule_meta(ENC) != encoders.schedule_meta(hcfg)
    with pytest.raises(TypeError):
        encoders.out_dim(object())
    g, _, _, _ = _setup(nx=12, ny=7, nz=5)
    via_dispatch = encoders.encode_grid(ENC, encoders.init_params(ENC), g)
    np.testing.assert_array_equal(
        np.asarray(via_dispatch), np.asarray(fourier.encode_grid(ENC, g))
    )


def _pointwise_total(g, w, ncfg, params, t):
    """The staged loss with the fields built from the POINTWISE forward
    (encoders.encode + the head) — a second code path to the same loss."""
    coords = ngp._unit_coords(g)
    ys = [ngp.forward(ncfg, params, coords, tt)
          for tt in (t - jnp.float32(g.dt), t, t + jnp.float32(g.dt))]
    fs = ops.FieldSnapshots(
        *[y[..., 0] for y in ys],
        *[jnp.moveaxis(y[..., 1:4], -1, 0) for y in ys],
    )
    ls, lu = ops.loss_forward(g, w, fs)
    return ls + lu


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
def test_fourier_train_grad_matches_pointwise_grad(periodic):
    """The jitted training gradient (grid encoder, shared layer-1 base)
    serves the Fourier family: loss, head grads and d_t equal jax.grad
    through the pointwise forward, and the parameter-free encoding's
    cotangent is the empty leaf."""
    g, w, ncfg, params = _setup(nx=24, periodic=periodic)
    t = jnp.float32(0.3)
    loss_ref, (g_ref, gt_ref) = jax.value_and_grad(
        lambda p, tt: _pointwise_total(g, w, ncfg, p, tt), argnums=(0, 1)
    )(params, t)
    loss, (grads, d_t) = jax.jit(jax.value_and_grad(
        lambda p, tt: _staged_total(g, w, ncfg, p, tt), argnums=(0, 1)
    ))(params, t)
    assert abs(float(loss) - float(loss_ref)) <= 1e-5 * abs(float(loss_ref))
    assert grads["tables"].size == 0
    tol = 1e-4 if periodic else 5e-3
    for k in ("W1", "b1", "W2", "b2"):
        assert _leaf_close(g_ref[k], grads[k], tol), k
    assert abs(float(d_t) - float(gt_ref)) <= max(
        5e-3 * abs(float(gt_ref)), 1e-6
    )


def test_fourier_upwind_unaligned_grad():
    """Unaligned nx + the upwind scheme through the same training
    gradient."""
    g, w, ncfg, params = _setup(nx=20, ny=16, nz=6, scheme="upwind")
    t = jnp.float32(0.3)
    loss_ref, g_ref = jax.value_and_grad(
        lambda p: _pointwise_total(g, w, ncfg, p, t))(params)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: _staged_total(g, w, ncfg, p, t)))(params)
    assert abs(float(loss) - float(loss_ref)) <= 1e-5 * abs(float(loss_ref))
    for k in ("W1", "b1", "W2", "b2"):
        assert _leaf_close(g_ref[k], grads[k], 1e-4), k


def test_fourier_sharded_matches_single():
    """The generic GSPMD sharded step (shard-local Fourier encoding,
    replicated params) takes the single-device step's first loss and
    trains on the mesh."""
    from phys_autodiff_tpu.parallel.mesh import make_mesh
    from phys_autodiff_tpu.parallel.sharded import (
        make_generic_sharded_train_step,
    )
    from phys_autodiff_tpu.train import loop as train_loop

    assert len(jax.devices()) >= 8
    mesh = make_mesh(8)
    g, w, ncfg, params = _setup(nx=24, nz=16)
    t = jnp.float32(0.3)
    cfg = train_loop.TrainConfig(t=0.3, learning_rate=1e-3)
    step1, st1 = train_loop.make_ngp_train_step(g, w, ncfg, cfg, params)
    _, l1 = step1(st1)
    step_n, init_n = make_generic_sharded_train_step(
        g, w, lambda p, tt: ngp.generate_fields(g, ncfg, p, tt, g.dt), mesh,
        _setup(nx=24, nz=16)[3],
    )
    pn, on = init_n()
    losses = []
    for _ in range(3):
        pn, on, ln = step_n(pn, on, t)
        losses.append(float(ln))
    assert abs(losses[0] - float(l1)) <= 5e-6 * abs(float(l1))
    assert losses[-1] < losses[0]


def test_fourier_train_step_matches_hand_rolled():
    """make_ngp_train_step is encoder-agnostic: one SGD step for the
    Fourier family equals value_and_grad of the staged loss plus the
    update written out by hand."""
    import optax

    from phys_autodiff_tpu.train import loop as train_loop

    g, w, ncfg, params = _setup(nx=24)
    cfg = train_loop.TrainConfig(t_sampling="fixed", learning_rate=1e-1,
                                 optimizer="sgd")
    step, st = train_loop.make_ngp_train_step(g, w, ncfg, cfg, params)
    st, loss = step(st)

    @jax.jit
    def hand_step(p):
        l, grads = jax.value_and_grad(
            lambda q: _staged_total(g, w, ncfg, q, jnp.float32(cfg.t)))(p)
        opt = optax.sgd(cfg.learning_rate)
        up, _ = opt.update(grads, opt.init(p), p)
        return l, optax.apply_updates(p, up)

    l_ref, ref = hand_step(params)
    assert abs(float(loss) - float(l_ref)) <= 1e-6 * abs(float(l_ref))
    for a, b in zip(jax.tree_util.tree_leaves(st.params),
                    jax.tree_util.tree_leaves(ref)):
        assert _leaf_close(b, a, 1e-6)


def test_fourier_checkpoint_meta_detects_family_swap(tmp_path):
    """A checkpoint saved under the Fourier schedule refuses to restore
    under a hash expectation (and vice versa) — the same silent-decode
    protection the hash family has."""
    from phys_autodiff_tpu.models.hash_encoder import HashEncodingConfig
    from phys_autodiff_tpu.train.checkpoint import restore_npz, save_npz

    _, _, ncfg, params = _setup()
    path = str(tmp_path / "ff.npz")
    save_npz(path, params, meta=ngp.checkpoint_meta(ncfg))
    back = restore_npz(path, params, expect_meta=ngp.checkpoint_meta(ncfg))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    other = ngp.NGPFieldConfig(
        encoding=FourierEncodingConfig(num_frequencies=3), hidden=16
    )
    with pytest.raises(ValueError):
        restore_npz(path, params, expect_meta=ngp.checkpoint_meta(other))
