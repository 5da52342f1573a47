"""Training-step benchmark (the reference's never-built M6 closed loop).

A training step is self-validating under the on-device timing loop: the
updated parameters ARE the carry, so every gradient (and therefore the whole
backward) must be computed at full shape each iteration — structurally
DCE-proof, like the generational-feedback residual timing. The loss scalar
is additionally folded into the carry so the forward pass of a custom-vjp
loss cannot be dropped.
"""

from __future__ import annotations

import jax.numpy as jnp

from phys_autodiff_tpu.bench.harness import time_loop
from phys_autodiff_tpu.train import loop as train_loop
from phys_autodiff_tpu.utils.config import GridSpec, MLPDims, MLPGridConfig, PhysWeights


def time_train_step(step_fn, state0) -> float:
    """ms/iter of a (state) -> (state, loss) training step."""

    def body(i, carry):
        acc, state = carry
        state, loss = step_fn(state)
        return acc + loss * jnp.float32(1e-6), state

    return time_loop(body, (jnp.float32(0.0), state0), target_seconds=2.0)


def bench_train_step(
    g: GridSpec, h: int = 128, seed: int = 777, variants=None
) -> dict:
    """ms/step for the staged and fused training steps at grid g.
    `variants` restricts to a subset (e.g. fused arms only at the unaligned
    benchmark grids, where the staged arm's cost adds bench time without
    information)."""
    w = PhysWeights()
    mcfg = MLPGridConfig(dims=MLPDims(H=h))
    out = {}
    all_variants = {
        "staged": train_loop.TrainConfig(use_fused=False),
        "fused": train_loop.TrainConfig(use_fused=True),
        "fused_bf16": train_loop.TrainConfig(use_fused=True, precision="bf16"),
    }
    for name, cfg in all_variants.items():
        if variants is not None and name not in variants:
            continue
        step = train_loop._make_step_fn(g, w, mcfg, cfg)
        state0 = train_loop.init_state(cfg, mcfg, seed=seed)
        out[name] = time_train_step(step, state0)
    return out


def bench_ngp_train_step(
    g: GridSpec, seed: int = 777, precision: str = "f32"
) -> float:
    """ms/step for the NGP hash-encoded field model (framework extension —
    no reference analogue): dense-level encoder, jax.value_and_grad through
    the XLA pipeline. precision="bf16" runs the head matmuls in the mixed
    tier."""
    from phys_autodiff_tpu.models import ngp
    from phys_autodiff_tpu.utils.config import PhysWeights as _PW

    ncfg = ngp.NGPFieldConfig()
    params = ngp.init_ngp_params(ncfg, seed=seed)
    cfg = train_loop.TrainConfig(t_sampling="fixed")
    step, state0 = train_loop.make_ngp_train_step(
        g, _PW(), ncfg, cfg, params, precision=precision
    )
    return time_train_step(lambda s: step(s), state0)
