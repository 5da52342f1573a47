"""Big-grid benchmark rows: the scale the reference cannot reach.

The reference's own memory plan (12*N floats of field storage) caps its
benchmark grids at 128x96x96 = 1.18 M cells. The big grids here are

    256 x 256 x 192 = 12.58 M cells   (~10.7x the flagship)
    256 x 256 x 256 = 16.78 M cells   (~14.2x the flagship)

Sizing: the plain `jax.value_and_grad` training step keeps a [3N, H]
hidden activation and its cotangent (5.49 GB of temporaries at the
flagship grid, H=128 — measured on an H100, PERF.md), which scales past the
card at these sizes; the fused step (pallas/fieldgen.py) keeps only the 12
field channels and their cotangent, so it is the arm timed here.

Everything is generated ON DEVICE (jax.random): building a gigabyte of
inputs on the host would dominate the wall time and prove nothing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from phys_autodiff_tpu import ops
from phys_autodiff_tpu.bench.harness import PhysRow, time_residual_op
from phys_autodiff_tpu.ops.stencil import FieldSnapshots
from phys_autodiff_tpu.utils.config import GridSpec

BIG_GRIDS = [(256, 256, 192), (256, 256, 256)]


def device_random_fields(g: GridSpec, seed: int = 0) -> FieldSnapshots:
    """FieldSnapshots drawn on device — no host materialization."""
    keys = jax.random.split(jax.random.PRNGKey(seed), 6)
    mk = lambda k, s: jax.random.normal(k, s, jnp.float32)
    return FieldSnapshots(
        sigma_tm1=mk(keys[0], g.shape),
        sigma_t=mk(keys[1], g.shape),
        sigma_tp1=mk(keys[2], g.shape),
        u_tm1=mk(keys[3], (3,) + g.shape),
        u_t=mk(keys[4], (3,) + g.shape),
        u_tp1=mk(keys[5], (3,) + g.shape),
    )


def big_phys_rows(g: GridSpec, iters: int = 10) -> list:
    """Timing row of the XLA residual op at a big grid (inputs drawn on
    device)."""
    ms = time_residual_op(lambda x: ops.residuals(g, x), device_random_fields(g))
    return [PhysRow("nonfused", g.nx, g.ny, g.nz, iters, ms)]


def big_train_ms(g: GridSpec, h: int = 128, variants=("fused", "fused_bf16")):
    """ms/step of the fused training step at a big grid."""
    from phys_autodiff_tpu.bench.trainbench import bench_train_step

    return bench_train_step(g, h=h, variants=variants)
