"""The 2-layer coordinate MLP: [x, y, z, t] -> [sigma, ux, uy, uz].

Reference behavior replicated (include/mlp.h:5-9, src/mlp_cpu.cpp:14-36):
    y = W2 . relu(W1 . x + b1) + b2
with a seeded uniform(-scale, scale) initializer (src/mlp_grid.cpp:8-19,
defaults seed=42, scale=0.5).

Differences from the reference (deliberate, documented):
  * Weight layout is [In, H] / [H, Out] (right-multiplication, batch on the
    leading axis) instead of the reference's row-major [H, In] / [Out, H]
    left-multiplication (src/mlp_cpu.cpp:15). `to_reference_layout` /
    `from_reference_layout` give the exact bijection (a transpose).
  * Initialization uses numpy's MT19937 generator seeded identically across
    hosts — deterministic, but not the same stream as std::mt19937 +
    uniform_real_distribution (parity tests always share weights across arms,
    so streams never need to match).
  * The backward pass is `jax.grad` — the reference hand-codes the same
    gradients for an MSE head only (src/mlp_cpu.cpp:38-85); `mse_loss` +
    `jax.grad` reproduces those exactly and extends to any head.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from phys_autodiff_tpu.utils.config import MLPDims

Params = Dict[str, jnp.ndarray]


def init_params(
    dims: MLPDims, seed: int = 42, scale: float = 0.5, dtype=jnp.float32
) -> Params:
    """Uniform(-scale, scale) init, fill order W1, b1, W2, b2 like the
    reference (src/mlp_grid.cpp:13-18), drawn from a seeded MT19937."""
    rng = np.random.Generator(np.random.MT19937(seed))

    def draw(*shape):
        return jnp.asarray(
            rng.uniform(-scale, scale, size=shape).astype(np.float32), dtype=dtype
        )

    # Draw in reference layout order ([H,In] then [Out,H]) and transpose to
    # this layout, so the same seed yields the same multiset of weights.
    w1 = draw(dims.H, dims.In).T  # [In, H]
    b1 = draw(dims.H)
    w2 = draw(dims.Out, dims.H).T  # [H, Out]
    b2 = draw(dims.Out)
    return {"W1": w1, "b1": b1, "W2": w2, "b2": b2}


def to_reference_layout(params: Params) -> dict[str, np.ndarray]:
    """This layout -> reference row-major layout (include/mlp_grid.h:19-24):
    W1 [H, In] flattened, b1 [H], W2 [Out, H] flattened, b2 [Out]."""
    return {
        "W1": np.asarray(params["W1"]).T.copy(),
        "b1": np.asarray(params["b1"]).copy(),
        "W2": np.asarray(params["W2"]).T.copy(),
        "b2": np.asarray(params["b2"]).copy(),
    }


def from_reference_layout(ref: dict[str, np.ndarray]) -> Params:
    return {
        "W1": jnp.asarray(np.asarray(ref["W1"]).T),
        "b1": jnp.asarray(ref["b1"]),
        "W2": jnp.asarray(np.asarray(ref["W2"]).T),
        "b2": jnp.asarray(ref["b2"]),
    }


def forward(params: Params, x: jnp.ndarray, precision: str = "f32") -> jnp.ndarray:
    """y = relu(x @ W1 + b1) @ W2 + b2.  x: [..., In] -> y: [..., Out].

    "f32": both matmuls in IEEE float32 (precision pinned to HIGHEST, so no
    TF32, which the f32 parity tolerances of the test ladder need).
    "bf16": layer 2 takes bf16 operands with f32 accumulation; layer 1
    stays f32 (the arithmetic of the kernel pair's bf16 tier,
    pallas/fieldgen.py).
    """
    if precision not in ("f32", "bf16"):
        raise ValueError(f"precision {precision!r}: expected 'f32' or 'bf16'")
    z1 = (
        jnp.dot(
            x,
            params["W1"],
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        + params["b1"]
    )
    a1 = jnp.maximum(z1, 0.0)
    w2 = params["W2"]
    if precision == "bf16":
        a1, w2 = a1.astype(jnp.bfloat16), w2.astype(jnp.bfloat16)
    return (
        jnp.dot(
            a1,
            w2,
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )
        + params["b2"]
    )


def mse_loss(params: Params, x: jnp.ndarray, y_target: jnp.ndarray) -> jnp.ndarray:
    """The reference backward's hard-coded head: L = mean((y - y_t)^2) over
    B*Out (src/mlp_cpu.cpp:56-58). `jax.grad(mse_loss)` reproduces the
    reference's dW1/db1/dW2/db2."""
    y = forward(params, x)
    return jnp.mean((y - y_target) ** 2)


mse_grads = jax.grad(mse_loss)
