"""Training demo on hardware: fit a field model against the physics loss
and show the loss curve (the reference's never-built M6 milestone), then
optionally SERVE the trained field by advecting tracer particles through
its velocity (apps/advect.py). Run from repo root:

    PYTHONPATH=.:$PYTHONPATH python scripts/train_demo.py \
        [steps] [model] [rollout_steps]

model: "mlp" (default, the reference's coordinate MLP) or "ngp" (the
hash-encoded field extension). rollout_steps > 0 appends the train->serve
demo: 100k particles advected rollout_steps RK2 steps through the trained
field.
"""

import sys
import time

from phys_autodiff_tpu.train import TrainConfig, fit
from phys_autodiff_tpu.utils.config import (
    GridSpec,
    MLPDims,
    MLPGridConfig,
    PhysWeights,
)


def _rollout(g, model_cfg, params, steps: int):
    """Train->serve: advect tracers through the trained velocity field."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from phys_autodiff_tpu.apps import advect as adv

    vel = adv.velocity_fn_from_model(g, model_cfg, params)
    pts0 = jax.random.uniform(
        jax.random.PRNGKey(0), (100_000, 3), jnp.float32,
        maxval=jnp.asarray([g.nx, g.ny, g.nz], jnp.float32),
    )
    acfg = adv.AdvectConfig(steps=steps, dt=g.dt, method="rk2")
    t0 = time.perf_counter()
    final = jax.block_until_ready(
        adv.make_advect_fn(g, vel, 0.25, acfg)(pts0)
    )
    elapsed = time.perf_counter() - t0
    drift = np.linalg.norm(np.asarray(final) - np.asarray(pts0), axis=1)
    assert np.all(np.isfinite(np.asarray(final)))
    print(
        f"rollout: {pts0.shape[0]} particles x {steps} RK2 steps in "
        f"{elapsed:.2f}s (incl. compile); mean|max drift "
        f"{drift.mean():.3f}/{drift.max():.3f} cells"
    )


def _fit_ngp(g, cfg):
    from phys_autodiff_tpu.models import ngp
    from phys_autodiff_tpu.train import make_generic_train_step

    ncfg = ngp.NGPFieldConfig()
    params = ngp.init_ngp_params(ncfg, seed=cfg.seed)
    step, state = make_generic_train_step(
        g, PhysWeights(),
        lambda p, t: ngp.generate_fields(g, ncfg, p, t, g.dt), cfg, params,
    )
    history = []
    t0 = time.perf_counter()
    for i in range(cfg.steps):
        state, loss = step(state)
        if i % cfg.log_every == 0 or i == cfg.steps - 1:
            loss_f = float(loss)
            history.append((i + 1, loss_f))
            print(f"step {i + 1:5d}  loss {loss_f:.6e}")
    return ncfg, state, history, time.perf_counter() - t0


if __name__ == "__main__":
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 300
    model = sys.argv[2] if len(sys.argv) > 2 else "mlp"
    rollout_steps = int(sys.argv[3]) if len(sys.argv) > 3 else 0
    g = GridSpec(nx=64, ny=64, nz=64, hx=0.1, hy=0.1, hz=0.1, dt=1e-3)
    cfg = TrainConfig(steps=steps, learning_rate=3e-3, log_every=max(1, steps // 20))
    if model == "ngp":
        model_cfg, state, history, elapsed = _fit_ngp(g, cfg)
    else:
        model_cfg = MLPGridConfig(dims=MLPDims(H=64))
        state, history, elapsed = fit(
            g, PhysWeights(), model_cfg, cfg,
            callback=lambda s, l: print(f"step {s:5d}  loss {l:.6e}"),
        )
    first, last = history[0][1], history[-1][1]
    drop = 100 * (1 - last / first)
    print(f"\n{model}: {steps} steps in {elapsed:.1f}s; loss {first:.4e} -> "
          f"{last:.4e} ({drop:.1f}% drop; reference criterion: >=90%)")
    if rollout_steps > 0:
        _rollout(g, model_cfg, state.params, rollout_steps)
