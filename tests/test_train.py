"""Training-loop tests: the reference's M6 acceptance criterion and
checkpoint round-trips.

REQUIREMENT.md:164-169 (the reference's never-built milestone): training the
MLP against the physics loss must drop the loss >= 90% within the budgeted
steps.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np

from phys_autodiff_tpu.train import (
    TrainConfig,
    checkpoint,
    fit,
    init_state,
    make_train_step,
)
from phys_autodiff_tpu.utils.config import (
    GridSpec,
    MLPDims,
    MLPGridConfig,
    PhysWeights,
)

G = GridSpec(nx=16, ny=16, nz=8, hx=0.4, hy=0.4, hz=0.8, dt=1e-2)
W = PhysWeights()
MCFG = MLPGridConfig(dims=MLPDims(H=32))


def test_loss_drops_90_percent():
    cfg = TrainConfig(steps=300, learning_rate=3e-3, t=0.25, seed=1, log_every=50)
    state, history, _ = fit(G, W, MCFG, cfg)
    first = history[0][1]
    last = history[-1][1]
    assert last <= 0.1 * first, f"loss only dropped {first} -> {last}"
    assert np.isfinite(last)


def test_train_step_deterministic():
    cfg = TrainConfig(steps=1, seed=7)
    step = make_train_step(G, W, MCFG, cfg)
    s1, l1 = step(init_state(cfg, MCFG))
    s2, l2 = step(init_state(cfg, MCFG))
    assert float(l1) == float(l2)
    for k in s1.params:
        np.testing.assert_array_equal(np.asarray(s1.params[k]), np.asarray(s2.params[k]))


def test_uniform_t_sampling_changes_loss():
    cfg = TrainConfig(steps=1, seed=3, t_sampling="uniform")
    step = make_train_step(G, W, MCFG, cfg)
    state = init_state(cfg, MCFG)
    state, l1 = step(state)
    state, l2 = step(state)
    assert float(l1) != float(l2)  # different sampled t each step


def test_checkpoint_roundtrip_npz(tmp_path):
    cfg = TrainConfig(steps=3, seed=2)
    step = make_train_step(G, W, MCFG, cfg)
    state = init_state(cfg, MCFG)
    for _ in range(3):
        state, _ = step(state)

    path = os.path.join(tmp_path, "ckpt")
    checkpoint.save_npz(path, state)
    restored = checkpoint.restore_npz(path, state)
    for a, b in zip(
        jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(restored)
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # resume: one more step from restored == one more step from original
    s1, l1 = step(state)
    s2, l2 = step(restored)
    assert float(l1) == float(l2)


def test_restore_unvalidated_still_checks_expect_meta(tmp_path):
    """allow_unvalidated=True (manifest-less restore) must not silently skip
    an explicitly requested expect_meta check: the schedule cannot be
    verified, and the caller must hear THAT, not just a generic no-manifest
    note."""
    import warnings

    import pytest

    tree = {"a": jnp.arange(3.0), "b": jnp.ones((2, 2))}
    path = os.path.join(tmp_path, "ckpt")
    checkpoint.save_npz(path, tree)
    # strip the embedded manifest and the sidecar (an old/copied checkpoint)
    with np.load(path + ".npz") as data:
        leaves = {k: data[k] for k in data.files if k.startswith("leaf_")}
    np.savez(path + ".npz", **leaves)
    os.remove(path + ".tree.json")

    with pytest.raises(ValueError, match="no embedded manifest"):
        checkpoint.restore_npz(path, tree)
    with pytest.warns(UserWarning) as rec:
        restored = checkpoint.restore_npz(
            path, tree, expect_meta={"schedule": [1, 2]},
            allow_unvalidated=True,
        )
    msgs = " | ".join(str(r.message) for r in rec)
    assert "cannot be verified" in msgs, msgs
    for a, b in zip(
        jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(restored)
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fit_scan_matches_fit():
    """The scan-based trainer must produce the same trajectory as the
    host-driven loop (same seed, fixed t)."""
    from phys_autodiff_tpu.train import fit_scan

    cfg = TrainConfig(steps=20, learning_rate=1e-3, seed=4, log_every=5)
    s1, h1, _ = fit(G, W, MCFG, cfg)
    s2, h2, _ = fit_scan(G, W, MCFG, cfg)
    for k in s1.params:
        np.testing.assert_allclose(
            np.asarray(s1.params[k]), np.asarray(s2.params[k]), rtol=1e-6
        )
    assert abs(h1[-1][1] - h2[-1][1]) <= 1e-6 * max(1.0, abs(h1[-1][1]))


def test_remat_training_matches_plain():
    """remat=True must be numerically identical (same program, recomputed
    residuals) while dropping saved activations."""
    cfg_a = TrainConfig(steps=3, learning_rate=1e-3, seed=6)
    cfg_b = TrainConfig(steps=3, learning_rate=1e-3, seed=6, remat=True)
    sa = init_state(cfg_a, MCFG)
    sb = init_state(cfg_b, MCFG)
    step_a = make_train_step(G, W, MCFG, cfg_a)
    step_b = make_train_step(G, W, MCFG, cfg_b)
    for _ in range(3):
        sa, la = step_a(sa)
        sb, lb = step_b(sb)
    # recompute can reassociate on CPU; near-identical is the contract
    assert abs(float(la) - float(lb)) <= 1e-6 * max(1.0, abs(float(la)))


def test_matmul_precision_bf16_trains():
    """bf16 matmul precision: step runs and the loss trajectory stays close
    to the f32 trajectory at small scale."""
    cfg32 = TrainConfig(steps=10, learning_rate=1e-3, seed=8)
    cfgbf = TrainConfig(steps=10, learning_rate=1e-3, seed=8, matmul_precision="bfloat16")
    s32 = init_state(cfg32, MCFG)
    sbf = init_state(cfgbf, MCFG)
    st32 = make_train_step(G, W, MCFG, cfg32)
    stbf = make_train_step(G, W, MCFG, cfgbf)
    for _ in range(10):
        s32, l32 = st32(s32)
        sbf, lbf = stbf(sbf)
    assert np.isfinite(float(lbf))
    assert abs(float(lbf) - float(l32)) <= 0.05 * max(abs(float(l32)), 1e-3)


def test_adamw_cosine_warmup_clip_trains():
    # the production optimizer chain: warmup -> cosine, decoupled weight
    # decay, global-norm clipping — must still satisfy the M6 criterion
    cfg = TrainConfig(
        steps=300, learning_rate=3e-3, t=0.25, seed=1, log_every=50,
        optimizer="adamw", weight_decay=1e-4, grad_clip=1.0,
        lr_schedule="cosine", warmup_steps=30,
    )
    state, history, _ = fit(G, W, MCFG, cfg)
    first, last = history[0][1], history[-1][1]
    assert last <= 0.1 * first, (first, last)
    assert np.isfinite(last)


def test_grad_clip_caps_first_update():
    # with SGD the first update is exactly -lr * clipped_grad, so the
    # param delta's global norm must be <= lr * clip
    from phys_autodiff_tpu.train.loop import make_optimizer

    clip = 0.01
    cfg = TrainConfig(steps=1, learning_rate=1.0, optimizer="sgd",
                      grad_clip=clip, seed=3)
    step = make_train_step(G, W, MCFG, cfg)
    state0 = init_state(cfg, MCFG)
    state1, _ = step(state0)
    deltas = jax.tree.map(lambda a, b: a - b, state1.params, state0.params)
    gnorm = float(
        jnp.sqrt(sum(jnp.sum(d * d) for d in jax.tree.leaves(deltas)))
    )
    assert gnorm <= clip * cfg.learning_rate * (1 + 1e-5), gnorm
    # sanity: the optimizer factory accepts every documented spelling
    for opt in ("adam", "adamw", "sgd"):
        make_optimizer(TrainConfig(optimizer=opt))


def test_cosine_schedule_values():
    from phys_autodiff_tpu.train.loop import make_schedule

    cfg = TrainConfig(steps=100, learning_rate=1e-2, lr_schedule="cosine",
                      warmup_steps=10, lr_final_scale=0.1)
    sched = make_schedule(cfg)
    assert float(sched(0)) == 0.0
    np.testing.assert_allclose(float(sched(10)), 1e-2, rtol=1e-6)
    np.testing.assert_allclose(float(sched(100)), 1e-3, rtol=1e-5)
