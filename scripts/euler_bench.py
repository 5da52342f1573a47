"""Incompressible-Euler step cost on the flagship grid.

Times the full apps/euler.py advect/force/project step (semi-Lagrangian
self-advection of 3 velocity components + buoyancy + exact FFT projection
+ density transport = 4 transported scalars, 3 rfftn/irfftn pairs and the
stencil div/grad per step) and the FFT projection alone, on-device loops
(bench/harness.time_loop) with the EulerState as the loop carry (each
step consumes the previous state — nothing can be DCE'd or hoisted).

Usage: python scripts/euler_bench.py          # step-cost arms
       python scripts/euler_bench.py --remat  # differentiable-horizon
           memory probe: XLA temp-buffer bytes for jax.grad through an
           N-step rollout, remat vs stored-intermediates (compile-time
           memory_analysis — exact, no OOM risk), plus one executed
           long-horizon remat gradient.
"""

from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from phys_autodiff_tpu.apps import euler
from phys_autodiff_tpu.bench.harness import time_loop
from phys_autodiff_tpu.ops import projection
from phys_autodiff_tpu.utils.cache import enable_compile_cache
from phys_autodiff_tpu.utils.config import GridSpec


def remat_probe() -> None:
    """Measure what EulerConfig.remat buys: the XLA temp-buffer footprint
    of jax.grad through an N-step rollout (the scan's saved residuals
    dominate), with and without per-step rematerialization."""
    g = GridSpec(nx=128, ny=96, nz=96, hx=0.05, hy=0.05, hz=0.05, dt=1e-3)
    rng = np.random.default_rng(0)
    sigma0 = jnp.asarray(rng.uniform(size=g.shape).astype(np.float32))
    target = jnp.asarray(rng.uniform(size=g.shape).astype(np.float32))
    u0 = jnp.asarray(
        (0.5 * rng.normal(size=(3,) + g.shape)).astype(np.float32)
    )
    kw = dict(dt=2e-3, buoyancy=0.5, projection="fft",
              advection="maccormack", confinement=2.0)

    def temp_gb(steps, remat):
        """XLA temp bytes for the compiled gradient, or None when the
        program cannot compile at all (running out of device memory is then
        a compile-time error — the honest result for the
        stored-intermediates arm past some horizon)."""
        cfg = euler.EulerConfig(steps=steps, remat=remat, **kw)
        fn = jax.jit(jax.grad(
            lambda u: euler.rollout_loss(g, u, sigma0, target, cfg)))
        try:
            mem = fn.lower(u0).compile().memory_analysis()
        except Exception as exc:  # noqa: BLE001 — classify, don't mask
            if "Ran out of memory" not in str(exc):
                raise
            return None
        return float(mem.temp_size_in_bytes) / 2**30

    out = {"metric": "euler_remat_grad_temp_gb", "grid": [g.nx, g.ny, g.nz],
           "arms": {}}
    for steps in (8, 32):
        plain = temp_gb(steps, False)
        rem = temp_gb(steps, True)
        out["arms"][f"steps{steps}"] = {
            "plain_gb": None if plain is None else round(plain, 3),
            "remat_gb": round(rem, 3),
            "ratio": None if plain is None else round(plain / rem, 2),
            "plain_compile_oom": plain is None,
        }
        print(f"euler_remat,{steps},{plain},{rem:.3f}", file=sys.stderr)
    # prove the long horizon actually executes under remat
    cfg = euler.EulerConfig(steps=96, remat=True, **kw)
    grad = jax.jit(jax.grad(
        lambda u: euler.rollout_loss(g, u, sigma0, target, cfg)))(u0)
    gn = float(jnp.linalg.norm(grad))
    assert np.isfinite(gn)
    out["executed"] = {"steps": 96, "grad_norm": gn}
    print(json.dumps(out))


def main() -> None:
    g = GridSpec(nx=128, ny=96, nz=96, hx=0.05, hy=0.05, hz=0.05, dt=1e-3)
    rng = np.random.default_rng(0)
    sigma0 = jnp.asarray(rng.uniform(size=g.shape).astype(np.float32))
    u0 = jnp.asarray(
        (0.5 * rng.normal(size=(3,) + g.shape)).astype(np.float32)
    )
    u0 = jax.jit(lambda v: projection.project_fft(g, v))(u0)
    cfg = euler.EulerConfig(dt=2e-3, buoyancy=0.5, projection="fft")

    def step_body(i, st):
        return euler.euler_step(g, st, cfg)

    arms = {}
    ms = time_loop(step_body, euler.EulerState(sigma0, u0))
    arms["euler_step_fft"] = {
        "ms_per_step": ms,
        "gcells_per_s": g.num_cells / (ms * 1e-3) / 1e9,
    }

    # the high-quality arm: second-order limited MacCormack advection +
    # vorticity confinement (2x transports per advected scalar + the
    # curl/grad stencil) — the cost of the "production smoke" step
    cfg_mc = euler.EulerConfig(
        dt=2e-3, buoyancy=0.5, projection="fft",
        advection="maccormack", confinement=2.0,
    )

    def step_body_mc(i, st):
        return euler.euler_step(g, st, cfg_mc)

    ms_mc = time_loop(step_body_mc, euler.EulerState(sigma0, u0))
    arms["euler_step_maccormack_conf"] = {
        "ms_per_step": ms_mc,
        "gcells_per_s": g.num_cells / (ms_mc * 1e-3) / 1e9,
    }

    def proj_body(i, v):
        return projection.project_fft(g, v)

    ms_p = time_loop(proj_body, u0)
    arms["project_fft"] = {
        "ms_per_step": ms_p,
        "gcells_per_s": g.num_cells / (ms_p * 1e-3) / 1e9,
    }
    for name, a in arms.items():
        print(
            f"euler,{name},{g.nx},{g.ny},{g.nz},{a['ms_per_step']:.4f},"
            f"{a['gcells_per_s']:.3f}",
            file=sys.stderr,
        )
    print(json.dumps({
        "metric": "euler_step_ms",
        "grid": [g.nx, g.ny, g.nz],
        "arms": arms,
    }))


if __name__ == "__main__":
    enable_compile_cache()
    if "--remat" in sys.argv[1:]:
        remat_probe()
    else:
        main()
