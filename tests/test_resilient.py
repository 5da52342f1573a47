"""Tests for train/resilient.py: checkpoint-every-K training with failure
detection and auto-resume (fault injection stands in for the real crashed-
GPU runtime faults the module is built against)."""

import jax.numpy as jnp
import numpy as np
import pytest

from phys_autodiff_tpu.train import loop, resilient
from phys_autodiff_tpu.utils.config import (
    GridSpec,
    MLPDims,
    MLPGridConfig,
    PhysWeights,
)


def _setup():
    g = GridSpec(nx=8, ny=6, nz=5, hx=0.5, hy=0.5, hz=0.5, dt=1e-3)
    w = PhysWeights()
    mcfg = MLPGridConfig(dims=MLPDims(H=16))
    cfg = loop.TrainConfig(steps=12, learning_rate=1e-3, seed=3)
    return g, w, mcfg, cfg


def _crashing_factory(g, w, mcfg, cfg, crash_at_call: int):
    """Wrap the real jitted step with one injected device-failure-shaped
    failure at the crash_at_call-th invocation."""
    calls = {"n": 0, "crashed": False}

    def factory():
        real = loop.make_train_step(g, w, mcfg, cfg)

        def step(state):
            calls["n"] += 1
            if calls["n"] == crash_at_call and not calls["crashed"]:
                calls["crashed"] = True
                raise RuntimeError("CUDA_ERROR_LAUNCH_FAILED: unspecified launch failure")
            return real(state)

        return step

    return factory, calls


def test_resilient_resumes_and_matches_uninterrupted_run(tmp_path):
    g, w, mcfg, cfg = _setup()
    state0 = loop.init_state(cfg, mcfg)

    # uninterrupted oracle: 12 plain steps
    plain_step = loop.make_train_step(g, w, mcfg, cfg)
    s_ref = state0
    for _ in range(cfg.steps):
        s_ref, loss_ref = plain_step(s_ref)

    factory, calls = _crashing_factory(g, w, mcfg, cfg, crash_at_call=7)
    rcfg = resilient.ResilienceConfig(
        ckpt_path=str(tmp_path / "ck"), save_every=5, max_restarts=2
    )
    state, history, report = resilient.fit_resilient(
        factory, state0, cfg.steps, rcfg
    )
    assert report.failures == 1 and report.restores == 1
    assert report.steps_done == cfg.steps
    assert int(state.step) == cfg.steps
    assert calls["crashed"]
    # deterministic replay from the step-5 checkpoint: the final parameters
    # match the uninterrupted run exactly (PRNG key lives in the state)
    np.testing.assert_array_equal(
        np.asarray(state.params["W1"]), np.asarray(s_ref.params["W1"])
    )
    np.testing.assert_array_equal(
        np.asarray(state.key), np.asarray(s_ref.key)
    )
    assert history[-1][0] == cfg.steps


def test_resilient_gives_up_after_max_restarts(tmp_path):
    g, w, mcfg, cfg = _setup()
    state0 = loop.init_state(cfg, mcfg)

    def factory():
        def step(state):
            raise RuntimeError("NCCL error: unhandled system error (connection closed)")

        return step

    rcfg = resilient.ResilienceConfig(
        ckpt_path=str(tmp_path / "ck"), save_every=4, max_restarts=2
    )
    with pytest.raises(RuntimeError, match="giving up after 2 restarts"):
        resilient.fit_resilient(factory, state0, 8, rcfg)


def test_resilient_reraises_programming_errors(tmp_path):
    g, w, mcfg, cfg = _setup()
    state0 = loop.init_state(cfg, mcfg)

    def factory():
        def step(state):
            raise ValueError("shapes do not match")

        return step

    rcfg = resilient.ResilienceConfig(
        ckpt_path=str(tmp_path / "ck"), save_every=4, max_restarts=5
    )
    with pytest.raises(ValueError, match="shapes do not match"):
        resilient.fit_resilient(factory, state0, 8, rcfg)


def test_default_failure_predicate_classification():
    p = resilient.default_failure_predicate

    class XlaRuntimeError(RuntimeError):  # stand-in for jaxlib's
        pass

    # retryable: runtime-error type AND infrastructure-shaped message
    assert p(XlaRuntimeError("grpc UNAVAILABLE: socket closed"))
    assert p(RuntimeError("CUDA_ERROR_LAUNCH_FAILED: unspecified launch failure"))
    assert p(RuntimeError("DEADLINE_EXCEEDED: barrier timed out waiting for peer"))
    # NOT retryable: deterministic errors must surface immediately —
    # a bare RuntimeError (user NaN guard), an XLA INTERNAL miscompile
    # (identical on every retry), or non-runtime exception types
    assert not p(RuntimeError("anything"))
    assert not p(XlaRuntimeError("INTERNAL: Mosaic lowering failed"))
    assert not p(Exception("grpc UNAVAILABLE: socket closed"))
    assert not p(ValueError("bad shape"))
    assert not p(TypeError("not a pytree"))


def test_resilient_checkpoint_cadence_and_history(tmp_path):
    g, w, mcfg, cfg = _setup()
    state0 = loop.init_state(cfg, mcfg)

    def factory():
        return loop.make_train_step(g, w, mcfg, cfg)

    rcfg = resilient.ResilienceConfig(
        ckpt_path=str(tmp_path / "ck"), save_every=5
    )
    state, history, report = resilient.fit_resilient(
        factory, state0, 12, rcfg
    )
    # initial + after bursts of 5, 5, 2
    assert report.checkpoints == 4
    assert report.failures == 0
    assert [h[0] for h in history] == [5, 10, 12]
    assert all(np.isfinite(h[1]) for h in history)
    # the on-disk checkpoint restores to the final state
    restored = resilient.checkpoint.restore_npz(rcfg.ckpt_path, state0)
    np.testing.assert_array_equal(
        np.asarray(restored.params["W2"]), np.asarray(state.params["W2"])
    )
    assert int(jnp.asarray(restored.step)) == 12


def test_resilient_resumes_from_existing_checkpoint(tmp_path):
    """resume="auto": a process-level death resumes by re-running the same
    command — the existing checkpoint is loaded, not clobbered."""
    g, w, mcfg, cfg = _setup()
    state0 = loop.init_state(cfg, mcfg)

    def factory():
        return loop.make_train_step(g, w, mcfg, cfg)

    rcfg = resilient.ResilienceConfig(
        ckpt_path=str(tmp_path / "ck"), save_every=4
    )
    # "process 1" runs 8 steps and exits
    s1, _, _ = resilient.fit_resilient(factory, state0, 8, rcfg)
    assert int(s1.step) == 8
    # "process 2" re-runs the same command asking for 12 total steps:
    # it must continue from step 8, not restart from state0
    s2, hist2, rep2 = resilient.fit_resilient(factory, state0, 12, rcfg)
    assert int(s2.step) == 12
    assert rep2.restores == 1  # the process-level resume
    assert [h[0] for h in hist2] == [12]
    # oracle: 12 uninterrupted steps match exactly
    plain = loop.make_train_step(g, w, mcfg, cfg)
    s_ref = state0
    for _ in range(12):
        s_ref, _ = plain(s_ref)
    np.testing.assert_array_equal(
        np.asarray(s2.params["W1"]), np.asarray(s_ref.params["W1"])
    )
    # resume="restart" really does start over
    s3, _, rep3 = resilient.fit_resilient(
        factory, state0, 4, rcfg, resume="restart"
    )
    assert int(s3.step) == 4 and rep3.restores == 0


def test_resilient_failure_during_recovery_consumes_budget(tmp_path):
    """A device that is still failing when the recovery re-traces must spend
    restarts, not kill the run."""
    g, w, mcfg, cfg = _setup()
    state0 = loop.init_state(cfg, mcfg)
    calls = {"factory": 0, "step": 0}

    def factory():
        calls["factory"] += 1
        if calls["factory"] == 2:
            # the FIRST rebuild after the crash fails too (backend still
            # recovering); the second succeeds
            raise RuntimeError("UNAVAILABLE: coordination service connection lost")
        real = loop.make_train_step(g, w, mcfg, cfg)

        def step(state):
            calls["step"] += 1
            if calls["step"] == 3:
                raise RuntimeError("device reset: CUDA_ERROR_LAUNCH_FAILED")
            return real(state)

        return step

    rcfg = resilient.ResilienceConfig(
        ckpt_path=str(tmp_path / "ck"), save_every=2, max_restarts=3
    )
    state, _, report = resilient.fit_resilient(factory, state0, 6, rcfg)
    assert int(state.step) == 6
    assert report.failures == 2  # the step crash + the failed rebuild
    assert calls["factory"] == 3  # initial + failed rebuild + good rebuild


def test_resilient_serves_the_ngp_step(tmp_path):
    """Cross-feature: fit_resilient over make_ngp_train_step (the encoded-
    field family) with an injected device failure — checkpoint meta carries
    the encoding schedule and must validate on resume."""
    from phys_autodiff_tpu.models import ngp
    from phys_autodiff_tpu.models.hash_encoder import HashEncodingConfig

    g = GridSpec(nx=8, ny=6, nz=5, hx=0.5, hy=0.5, hz=0.5, dt=1e-3)
    enc = HashEncodingConfig(
        num_levels=2, base_resolution=4, max_resolution=6,
        log2_table_size=6,
    )
    ncfg = ngp.NGPFieldConfig(encoding=enc, hidden=8)
    params0 = ngp.init_ngp_params(ncfg, seed=0)
    cfg = loop.TrainConfig(steps=6, learning_rate=1e-3, seed=1)
    calls = {"n": 0, "crashed": False}

    def factory():
        real, state0 = loop.make_ngp_train_step(
            g, PhysWeights(), ncfg, cfg, params0
        )
        factory.state0 = state0

        def step(state):
            calls["n"] += 1
            if calls["n"] == 4 and not calls["crashed"]:
                calls["crashed"] = True
                raise RuntimeError("device reset: CUDA_ERROR_LAUNCH_FAILED")
            return real(state)

        return step

    step0 = factory()  # materialize state0
    rcfg = resilient.ResilienceConfig(
        ckpt_path=str(tmp_path / "ngp"), save_every=2, max_restarts=2,
        meta=ngp.checkpoint_meta(ncfg),
    )
    state, hist, report = resilient.fit_resilient(
        lambda: factory(), factory.state0, 6, rcfg
    )
    assert report.failures == 1 and report.steps_done == 6
    assert int(state.step) == 6
    assert all(np.isfinite(h[1]) for h in hist)


def test_resilient_stepless_pytree_tracks_progress(tmp_path):
    """A plain params-dict state (no .step attribute) must not lose its
    progress count across failures or process-level resumes: the completed-
    step counter rides the checkpoint manifest, not the state (otherwise a
    late failure re-runs the FULL budget on top of the checkpoint,
    over-training the model)."""
    # deterministic "optimizer": x <- x + 1, so the step count IS the value
    calls = {"n": 0, "crashed": False}

    def factory():
        def step(state):
            calls["n"] += 1
            if calls["n"] == 9 and not calls["crashed"]:
                calls["crashed"] = True
                raise RuntimeError("CUDA_ERROR_LAUNCH_FAILED: unspecified launch failure")
            return {"x": state["x"] + 1.0}, jnp.float32(0.0)

        return step

    state0 = {"x": jnp.zeros(())}
    rcfg = resilient.ResilienceConfig(
        ckpt_path=str(tmp_path / "ck"), save_every=4, max_restarts=2
    )
    # crash at call 9 = first step after the step-8 checkpoint; resume must
    # redo only steps 9..10, landing on exactly x == 10
    state, history, report = resilient.fit_resilient(factory, state0, 10, rcfg)
    assert report.failures == 1 and report.restores == 1
    assert report.steps_done == 10
    assert float(state["x"]) == 10.0
    assert [h[0] for h in history] == [4, 8, 10]

    # process-level resume: asking for 14 total continues from 10, not 0
    s2, hist2, rep2 = resilient.fit_resilient(factory, state0, 14, rcfg)
    assert float(s2["x"]) == 14.0
    assert rep2.steps_done == 14 and rep2.restores == 1
    assert [h[0] for h in hist2] == [14]
