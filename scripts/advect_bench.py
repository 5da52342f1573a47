"""Particle-advection throughput on hardware: particles * steps / sec.

The project north star frames throughput in particles*steps/sec; the
reference has no particles (SURVEY.md §0), so there is no baseline row to
beat — this script establishes the framework's own number for the app layer
(apps/advect.py) on the flagship field model.

Arms:
  * direct  — velocity from direct MLP evaluation at the particle positions
              (exact, time-dependent; H=128 flagship head)
  * grid    — velocity by trilinear sampling of a frozen [3, nz, ny, nx]
              snapshot generated once by the same model

Timing: ONE advection step as the body of bench.harness.time_loop
(on-device fori_loop ended by block_until_ready, loop-carried positions —
each step's velocity query depends on the previous step's output, so
nothing can be hoisted or narrowed).

Usage: python scripts/advect_bench.py [n_particles] [method]
         n_particles default 1_000_000; method euler|rk2 (default rk2)
"""

from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp

from phys_autodiff_tpu.apps import advect as adv
from phys_autodiff_tpu.bench.harness import time_loop
from phys_autodiff_tpu.models import fields, mlp
from phys_autodiff_tpu.utils.cache import enable_compile_cache
from phys_autodiff_tpu.utils.config import GridSpec, MLPDims, MLPGridConfig


def main(n_particles: int = 1_000_000, method: str = "rk2") -> None:
    g = GridSpec(nx=128, ny=96, nz=96, hx=0.05, hy=0.05, hz=0.05, dt=1e-3)
    cfg = MLPGridConfig(dims=MLPDims(H=128))
    params = mlp.init_params(cfg.dims, seed=777)
    acfg = adv.AdvectConfig(steps=1, dt=1e-3, method=method)

    key = jax.random.PRNGKey(0)
    pts0 = jax.random.uniform(
        key, (n_particles, 3), jnp.float32,
        maxval=jnp.asarray([g.nx, g.ny, g.nz], jnp.float32),
    )

    arms = {}
    vel_direct = adv.velocity_fn_from_model(g, cfg, params)
    vel_bf16 = adv.velocity_fn_from_model(g, cfg, params, precision="bf16")
    y = fields.grid_infer(g, cfg, params, 0.25)  # one inference, 4 channels
    u_grid = jnp.moveaxis(y[..., 1:4], -1, 0)
    vel_grid = adv.velocity_fn_from_grid(g, u_grid)

    for name, vel in (
        ("direct", vel_direct),
        ("direct_bf16", vel_bf16),
        ("grid", vel_grid),
    ):
        def body(i, pts, vel=vel):
            # one advection step; t advances with the trip index so the
            # direct arm's MLP input is not loop-invariant in t either
            return adv.advect(
                g, vel, pts, jnp.float32(0.0) + 1e-6 * i, acfg
            )

        ms = time_loop(body, pts0)
        arms[name] = {
            "ms_per_step": ms,
            "particles_steps_per_sec": n_particles / (ms * 1e-3),
        }
        print(
            f"advect,{name},{method},{n_particles},{ms:.4f},"
            f"{arms[name]['particles_steps_per_sec']:.3e}",
            file=sys.stderr,
        )

    print(json.dumps({
        "metric": "advect_particles_steps_per_sec",
        "method": method,
        "n_particles": n_particles,
        "arms": arms,
    }))


if __name__ == "__main__":
    enable_compile_cache()
    if len(sys.argv) not in (1, 2, 3):
        print(
            "usage: python scripts/advect_bench.py [n_particles] "
            "[euler|rk2]",
            file=sys.stderr,
        )
        raise SystemExit(2)
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    m = sys.argv[2] if len(sys.argv) > 2 else "rk2"
    main(n, m)
