"""Hash-encoder / NGP field model tests (framework extension; no reference
analogue — SURVEY.md §0 notes the reference has no hash grid)."""

import jax
import jax.numpy as jnp
import numpy as np

from phys_autodiff_tpu.models import hash_encoder, ngp
from phys_autodiff_tpu.models.hash_encoder import HashEncodingConfig
from phys_autodiff_tpu.train import TrainConfig, make_generic_train_step
from phys_autodiff_tpu.utils.config import GridSpec, PhysWeights

CFG = HashEncodingConfig(
    num_levels=4, features_per_level=2, log2_table_size=10,
    base_resolution=4, max_resolution=32,
)


def test_encode_shapes_and_determinism():
    tables = hash_encoder.init_hash_params(CFG, seed=3)
    coords = jnp.asarray(
        np.random.default_rng(0).uniform(0, 1, (17, 3)), jnp.float32
    )
    out1 = hash_encoder.encode(CFG, tables, coords)
    out2 = hash_encoder.encode(CFG, tables, coords)
    assert out1.shape == (17, CFG.out_dim)
    np.testing.assert_array_equal(np.asarray(out1), np.asarray(out2))
    # batched shapes
    out3 = hash_encoder.encode(CFG, tables, coords.reshape(1, 17, 3))
    assert out3.shape == (1, 17, CFG.out_dim)


def test_trilinear_interpolation_at_corners():
    """At exact level-grid corner points the encoding must equal the single
    hashed corner feature (all interpolation weight on one corner)."""
    cfg = HashEncodingConfig(
        num_levels=1, features_per_level=2, log2_table_size=8,
        base_resolution=5, max_resolution=5,
    )
    tables = hash_encoder.init_hash_params(cfg, seed=1, scale=0.5)
    # grid point (2, 3, 1) of a resolution-5 level: coord = idx / (res-1)
    coord = jnp.asarray([[2 / 4, 3 / 4, 1 / 4]], jnp.float32)
    out = hash_encoder.encode(cfg, tables, coord)
    idx = hash_encoder._hash_corner(
        jnp.asarray([2]), jnp.asarray([3]), jnp.asarray([1]), cfg.table_size
    )
    expected = np.asarray(tables)[0, int(idx[0])]
    np.testing.assert_allclose(np.asarray(out)[0], expected, rtol=1e-5)


def test_encode_midpoint_is_average():
    """Halfway between corners along x, the encoding is the mean of the two
    corner features (all other dims on-corner)."""
    cfg = HashEncodingConfig(
        num_levels=1, features_per_level=2, log2_table_size=8,
        base_resolution=3, max_resolution=3,
    )
    tables = hash_encoder.init_hash_params(cfg, seed=2, scale=0.5)
    t = np.asarray(tables)[0]
    coord = jnp.asarray([[0.25, 0.0, 0.0]], jnp.float32)  # x=0.5 in level units
    out = hash_encoder.encode(cfg, tables, coord)
    i0 = int(hash_encoder._hash_corner(jnp.asarray([0]), jnp.asarray([0]), jnp.asarray([0]), cfg.table_size)[0])
    i1 = int(hash_encoder._hash_corner(jnp.asarray([1]), jnp.asarray([0]), jnp.asarray([0]), cfg.table_size)[0])
    np.testing.assert_allclose(np.asarray(out)[0], 0.5 * (t[i0] + t[i1]), rtol=1e-5)


def test_encoding_differentiable_in_tables():
    tables = hash_encoder.init_hash_params(CFG, seed=5)
    coords = jnp.asarray(
        np.random.default_rng(1).uniform(0, 1, (32, 3)), jnp.float32
    )

    def loss(t):
        return jnp.sum(hash_encoder.encode(CFG, t, coords) ** 2)

    g = jax.jit(jax.grad(loss))(tables)
    assert g.shape == tables.shape
    assert float(jnp.sum(jnp.abs(g))) > 0.0
    assert bool(jnp.all(jnp.isfinite(g)))


def test_ngp_generate_fields_and_training():
    """NGP field model plugs into the physics pipeline and trains: loss must
    drop substantially in a short run."""
    g = GridSpec(nx=16, ny=16, nz=8, hx=0.4, hy=0.4, hz=0.8, dt=1e-2)
    ncfg = ngp.NGPFieldConfig(encoding=CFG, hidden=32)
    params = ngp.init_ngp_params(ncfg, seed=0)

    fs = jax.jit(lambda p: ngp.generate_fields(g, ncfg, p, 0.25, g.dt))(params)
    assert fs.sigma_t.shape == g.shape
    assert fs.u_t.shape == (3,) + g.shape
    for arr in fs:
        assert bool(jnp.all(jnp.isfinite(arr)))

    cfg = TrainConfig(steps=150, learning_rate=5e-3, seed=0)
    step, state = make_generic_train_step(
        g, PhysWeights(), lambda p, t: ngp.generate_fields(g, ncfg, p, t, g.dt),
        cfg, params,
    )
    state, loss0 = step(state)
    for _ in range(cfg.steps - 1):
        state, loss = step(state)
    assert float(loss) < 0.2 * float(loss0), (float(loss0), float(loss))


def test_encode_grid_matches_pointwise_encode():
    """The regular-grid encoder (static-index corner gathers + separable
    resampling) is the same trilinear hash encoding as the pointwise
    `encode`, up to f32 re-association of the interpolation weights."""
    from phys_autodiff_tpu.models.ngp import _unit_coords

    g = GridSpec(nx=12, ny=7, nz=5, hx=0.1, hy=0.1, hz=0.1, dt=1e-3)
    tables = hash_encoder.init_hash_params(CFG, seed=9, scale=0.5)
    ref = hash_encoder.encode(CFG, tables, _unit_coords(g))
    out = hash_encoder.encode_grid(CFG, tables, g)
    assert out.shape == ref.shape
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=2e-5, atol=1e-6)


def test_encode_grid_degenerate_axis():
    """nz=1 grids (degenerate axis) take the weight-0 corner path."""
    g = GridSpec(nx=8, ny=6, nz=1, hx=0.1, hy=0.1, hz=0.1, dt=1e-3)
    from phys_autodiff_tpu.models.ngp import _unit_coords

    tables = hash_encoder.init_hash_params(CFG, seed=4, scale=0.5)
    ref = hash_encoder.encode(CFG, tables, _unit_coords(g))
    out = hash_encoder.encode_grid(CFG, tables, g)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=2e-5, atol=1e-6)


def test_encode_grid_gradients_flow_to_tables():
    """jax.grad reaches the hash tables through the grid encoder (the
    static-index takes backward to scatter-adds)."""
    g = GridSpec(nx=8, ny=8, nz=4, hx=0.1, hy=0.1, hz=0.1, dt=1e-3)
    tables = hash_encoder.init_hash_params(CFG, seed=5, scale=0.5)

    def loss(tb):
        return jnp.sum(hash_encoder.encode_grid(CFG, tb, g) ** 2)

    gr = jax.grad(loss)(tables)
    assert gr.shape == tables.shape
    assert float(jnp.sum(jnp.abs(gr))) > 0.0


def test_encode_grid_gradients_match_pointwise():
    """The sorted-segment-sum adjoint of the grid encoder's corner gather
    produces the same table gradients as autodiff of the pointwise
    encoder (weight-precision noise only)."""
    from phys_autodiff_tpu.models.ngp import _unit_coords

    g = GridSpec(nx=10, ny=6, nz=4, hx=0.1, hy=0.1, hz=0.1, dt=1e-3)
    tables = hash_encoder.init_hash_params(CFG, seed=12, scale=0.5)

    def loss_point(tb):
        return jnp.sum(hash_encoder.encode(CFG, tb, _unit_coords(g)) ** 2)

    def loss_grid(tb):
        return jnp.sum(hash_encoder.encode_grid(CFG, tb, g) ** 2)

    g1 = np.asarray(jax.grad(loss_point)(tables), np.float64)
    g2 = np.asarray(jax.grad(loss_grid)(tables), np.float64)
    scale = np.max(np.abs(g1)) + 1e-30
    assert np.max(np.abs(g1 - g2)) / scale < 1e-4


# --- Dense-level encoder (the scatter-free NGP backward) --------------------

# Oversubscribed top levels: T=256, resolutions [4, 8, 16] -> corner counts
# 125, 729, 4913; levels 1 and 2 exceed T and go dense.
DENSE_CFG = HashEncodingConfig(
    num_levels=3, features_per_level=2, log2_table_size=8,
    base_resolution=4, max_resolution=16, dense_oversubscribed=True,
)


def test_dense_level_selection_and_param_structure():
    assert DENSE_CFG.dense_levels() == [1, 2]
    assert DENSE_CFG.hash_levels() == [0]
    params = hash_encoder.init_hash_params(DENSE_CFG, seed=7)
    assert set(params) == {"hash", "dense"}
    assert params["hash"].shape == (1, 256, 2)
    assert params["dense"]["l1"].shape == (9, 9, 9, 2)
    assert params["dense"]["l2"].shape == (17, 17, 17, 2)
    # all-hash config keeps the legacy array (and the identical draw order)
    legacy_cfg = HashEncodingConfig(
        num_levels=3, features_per_level=2, log2_table_size=8,
        base_resolution=4, max_resolution=16,
    )
    legacy = hash_encoder.init_hash_params(legacy_cfg, seed=7)
    assert legacy.shape == (3, 256, 2)


def test_dense_config_rejects_legacy_array():
    import pytest

    legacy = jnp.zeros((3, 256, 2), jnp.float32)
    with pytest.raises(TypeError, match="dense levels"):
        hash_encoder.encode(DENSE_CFG, legacy, jnp.zeros((4, 3)))


def test_dense_encode_grid_matches_pointwise():
    """The matmul-resampled dense levels equal the pointwise dense lerp (and
    hashed level 0 keeps its existing path) on a regular grid."""
    from phys_autodiff_tpu.models.ngp import _unit_coords

    g = GridSpec(nx=12, ny=7, nz=5, hx=0.1, hy=0.1, hz=0.1, dt=1e-3)
    params = hash_encoder.init_hash_params(DENSE_CFG, seed=9, scale=0.5)
    ref = hash_encoder.encode(DENSE_CFG, params, _unit_coords(g))
    out = hash_encoder.encode_grid(DENSE_CFG, params, g)
    assert out.shape == ref.shape
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=2e-5, atol=1e-6)


def test_dense_encode_grid_gradients_match_pointwise():
    """The transposed-matmul backward of dense levels produces the same
    parameter gradients as autodiff of the pointwise dense path."""
    from phys_autodiff_tpu.models.ngp import _unit_coords

    g = GridSpec(nx=10, ny=6, nz=4, hx=0.1, hy=0.1, hz=0.1, dt=1e-3)
    params = hash_encoder.init_hash_params(DENSE_CFG, seed=12, scale=0.5)

    def loss_point(p):
        return jnp.sum(hash_encoder.encode(DENSE_CFG, p, _unit_coords(g)) ** 2)

    def loss_grid(p):
        return jnp.sum(hash_encoder.encode_grid(DENSE_CFG, p, g) ** 2)

    g1 = jax.grad(loss_point)(params)
    g2 = jax.grad(loss_grid)(params)
    for k1, k2 in [
        (g1["hash"], g2["hash"]),
        (g1["dense"]["l1"], g2["dense"]["l1"]),
        (g1["dense"]["l2"], g2["dense"]["l2"]),
    ]:
        a = np.asarray(k1, np.float64)
        b = np.asarray(k2, np.float64)
        scale = np.max(np.abs(a)) + 1e-30
        assert np.max(np.abs(a - b)) / scale < 1e-4


def test_dense_grid_backward_has_no_scatter():
    """The point of dense levels: their encode_grid backward must lower to
    transposed matmuls, with NO scatter for the dense parameters. (Hashed
    level 0 still scatters into its table — only the dense grids are
    checked by excluding the hash path from the program.)"""
    dense_only = HashEncodingConfig(
        num_levels=1, features_per_level=2, log2_table_size=4,
        base_resolution=8, max_resolution=8, dense_oversubscribed=True,
    )
    assert dense_only.dense_levels() == [0]
    g = GridSpec(nx=12, ny=8, nz=6, hx=0.1, hy=0.1, hz=0.1, dt=1e-3)
    params = hash_encoder.init_hash_params(dense_only, seed=1)

    def loss(p):
        return jnp.sum(hash_encoder.encode_grid(dense_only, p, g) ** 2)

    import re

    txt = jax.jit(jax.grad(loss)).lower(params).compile().as_text()
    # match scatter OPS (e.g. "= f32[9,9,9,2] scatter(..."), not the test's
    # own name echoed in op metadata
    assert not re.search(r"\bscatter\(", txt), "dense backward lowered a scatter"


def test_dense_encode_degenerate_axis():
    from phys_autodiff_tpu.models.ngp import _unit_coords

    g = GridSpec(nx=8, ny=6, nz=1, hx=0.1, hy=0.1, hz=0.1, dt=1e-3)
    params = hash_encoder.init_hash_params(DENSE_CFG, seed=4, scale=0.5)
    ref = hash_encoder.encode(DENSE_CFG, params, _unit_coords(g))
    out = hash_encoder.encode_grid(DENSE_CFG, params, g)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=2e-5, atol=1e-6)


def test_pointwise_encode_accepts_grid_scale_batches():
    """The pointwise (gather) encoder takes a whole grid's worth of points
    (on a GPU gathers are the native path; no size guard) and equals the
    broadcast grid path there."""
    g = GridSpec(nx=16, ny=12, nz=10, hx=0.4, hy=0.4, hz=0.4, dt=1e-2)
    tables = hash_encoder.init_hash_params(CFG, seed=3)
    coords = ngp._unit_coords(g).reshape(-1, 3)  # one flat batch
    assert coords.shape[0] == g.num_cells
    out = hash_encoder.encode(CFG, tables, coords)
    ref = hash_encoder.encode_grid(CFG, tables, g)
    np.testing.assert_allclose(
        np.asarray(out).reshape(ref.shape), np.asarray(ref),
        rtol=2e-5, atol=1e-6,
    )


def test_ngp_dense_default_trains():
    """The new default NGPFieldConfig (dense oversubscribed levels) trains
    through the physics loss like the hash variant."""
    g = GridSpec(nx=12, ny=8, nz=6, hx=0.4, hy=0.4, hz=0.8, dt=1e-2)
    enc = HashEncodingConfig(
        num_levels=3, features_per_level=2, log2_table_size=8,
        base_resolution=4, max_resolution=16, dense_oversubscribed=True,
    )
    ncfg = ngp.NGPFieldConfig(encoding=enc, hidden=16)
    params = ngp.init_ngp_params(ncfg, seed=0)
    fs = jax.jit(lambda p: ngp.generate_fields(g, ncfg, p, 0.25, g.dt))(params)
    for arr in fs:
        assert bool(jnp.all(jnp.isfinite(arr)))

    cfg = TrainConfig(steps=120, learning_rate=5e-3, seed=0)
    step, state = make_generic_train_step(
        g, PhysWeights(), lambda p, t: ngp.generate_fields(g, ncfg, p, t, g.dt),
        cfg, params,
    )
    state, loss0 = step(state)
    for _ in range(cfg.steps - 1):
        state, loss = step(state)
    assert float(loss) < 0.25 * float(loss0), (float(loss0), float(loss))


def test_ngp_checkpoint_meta_roundtrip(tmp_path):
    """NGP checkpoints record their encoding schedule; restoring with a
    different schedule fails loudly instead of decoding different
    fields."""
    import pytest

    from phys_autodiff_tpu.train import checkpoint

    ncfg = ngp.NGPFieldConfig(encoding=DENSE_CFG, hidden=8)
    params = ngp.init_ngp_params(ncfg, seed=0)
    path = str(tmp_path / "ngp_ckpt")
    checkpoint.save_npz(path, params, meta=ngp.checkpoint_meta(ncfg))
    restored = checkpoint.restore_npz(
        path, params, expect_meta=ngp.checkpoint_meta(ncfg)
    )
    np.testing.assert_array_equal(
        np.asarray(restored["tables"]["dense"]["l2"]),
        np.asarray(params["tables"]["dense"]["l2"]),
    )
    other = ngp.NGPFieldConfig(
        encoding=HashEncodingConfig(
            num_levels=3, features_per_level=2, log2_table_size=8,
            base_resolution=4, max_resolution=24, dense_oversubscribed=True,
        ),
        hidden=8,
    )
    with pytest.raises(ValueError, match="meta"):
        checkpoint.restore_npz(path, params, expect_meta=ngp.checkpoint_meta(other))


def test_head_base_factoring_matches_apply_head():
    """generate_fields' shared layer-1 base (time as a rank-1 term) equals
    the concat formulation of _apply_head up to one f32 reassociation."""
    ncfg = ngp.NGPFieldConfig(encoding=CFG, hidden=32)
    params = ngp.init_ngp_params(ncfg, seed=3)
    enc = jnp.asarray(
        np.random.default_rng(2).standard_normal((7, 9, CFG.out_dim)), jnp.float32
    )
    for t in (0.0, 0.25, 0.9):
        ref = ngp._apply_head(params, enc, t)
        out = ngp._head_from_base(params, ngp._head_base(params, enc), t)
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(ref), rtol=2e-6, atol=2e-6
        )


def test_generic_step_matches_hand_rolled_step():
    """make_ngp_train_step is jax.value_and_grad of the staged loss plus
    one optimizer update: it equals that step written out by hand (SGD, so
    the update is linear in the gradient)."""
    import optax

    from phys_autodiff_tpu import ops
    from phys_autodiff_tpu.train import loop as train_loop

    g = GridSpec(nx=12, ny=8, nz=6, hx=0.3, hy=0.3, hz=0.3, dt=1e-2)
    ncfg = ngp.NGPFieldConfig(encoding=CFG, hidden=16)
    params = ngp.init_ngp_params(ncfg, seed=1)
    cfg = TrainConfig(t_sampling="fixed", learning_rate=1e-1,
                      optimizer="sgd", seed=0)
    step, st = train_loop.make_ngp_train_step(g, PhysWeights(), ncfg, cfg,
                                              params)
    st, loss = step(st)

    def total(p):
        return ops.total_loss(
            g, PhysWeights(), ngp.generate_fields(g, ncfg, p, cfg.t, g.dt))

    @jax.jit
    def hand_step(p):
        l, grads = jax.value_and_grad(total)(p)
        opt = optax.sgd(cfg.learning_rate)
        up, _ = opt.update(grads, opt.init(p), p)
        return l, optax.apply_updates(p, up)

    l_ref, ref = hand_step(params)
    assert abs(float(loss) - float(l_ref)) <= 1e-6 * abs(float(l_ref))
    for a, b in zip(jax.tree_util.tree_leaves(st.params),
                    jax.tree_util.tree_leaves(ref)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert np.linalg.norm(a - b) <= 1e-6 * max(np.linalg.norm(b), 1e-30)


def test_generate_fields_bf16_head_within_mixed_tolerance():
    """The bf16 decode-head tier (exact-f32 encoder, bf16 matmul operands
    with f32 accumulation) stays in the few-percent mixed class on the
    FIELDS (two bf16 dots)."""
    g = GridSpec(nx=12, ny=8, nz=6, hx=0.3, hy=0.3, hz=0.3, dt=1e-2)
    ncfg = ngp.NGPFieldConfig(encoding=DENSE_CFG, hidden=32)
    params = ngp.init_ngp_params(ncfg, seed=5)
    ref = ngp.generate_fields(g, ncfg, params, 0.25, g.dt)
    out = ngp.generate_fields(g, ncfg, params, 0.25, g.dt, precision="bf16")
    for a, b in zip(ref, out):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = np.max(np.abs(a)) + 1e-30
        assert np.max(np.abs(a - b)) / scale < 5e-2
