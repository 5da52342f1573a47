"""Measure the supervised neural-field fitting workload (train/fit_field)
on the flagship grid: per-step cost of the data-loss fit for both model
families, plus fit quality (PSNR) and compression ratio after a fixed
step budget.

This is the Instant-NGP-style headline for the framework's data path —
"compress a 128x96x96x4 f32 snapshot into a neural field" — with the
measurement doctrine of the repo (an on-device loop with the optimizer
state as the loop carry, so no step can be DCE'd or hoisted).

Usage: python scripts/fit_bench.py [steps]   (default 300)
"""

from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax

from phys_autodiff_tpu.bench.harness import time_loop
from phys_autodiff_tpu.models.ngp import NGPFieldConfig
from phys_autodiff_tpu.train import TrainConfig
from phys_autodiff_tpu.train import fit_field as ff
from phys_autodiff_tpu.train.loop import make_optimizer
from phys_autodiff_tpu.utils.cache import enable_compile_cache
from phys_autodiff_tpu.utils.config import GridSpec, MLPDims, MLPGridConfig


def make_target(g: GridSpec) -> ff.FitTarget:
    """A detail-rich but deterministic target: multi-octave trig mix (the
    kind of multi-scale content hash encodings exist for)."""
    z, y, x = jnp.meshgrid(
        jnp.arange(g.nz), jnp.arange(g.ny), jnp.arange(g.nx), indexing="ij"
    )
    xs, ys, zs = x / g.nx, y / g.ny, z / g.nz
    two_pi = 2 * jnp.pi
    sigma = (
        0.5 * jnp.sin(two_pi * xs) * jnp.cos(two_pi * ys)
        + 0.25 * jnp.sin(3 * two_pi * (xs + zs))
        + 0.125 * jnp.cos(7 * two_pi * ys) * jnp.sin(5 * two_pi * zs)
    )
    u = jnp.stack(
        [
            0.4 * jnp.cos(two_pi * zs) + 0.1 * jnp.sin(4 * two_pi * ys),
            0.3 * jnp.sin(two_pi * xs) * jnp.cos(3 * two_pi * zs),
            0.2 * jnp.cos(2 * two_pi * (xs + ys)),
        ]
    )
    return ff.FitTarget(
        sigma.astype(jnp.float32), u.astype(jnp.float32), 0.25
    )


def bench_family(name, g, mcfg, tgt, steps, lr) -> dict:
    tc = TrainConfig(steps=steps, learning_rate=lr, seed=0)
    loss_and_grad = jax.value_and_grad(ff.make_fit_loss(g, mcfg, [tgt]))

    opt = make_optimizer(tc)
    params0 = ff.init_any(mcfg, seed=0)

    def body(i, carry):
        params, opt_state = carry
        _, grads = loss_and_grad(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    ms = time_loop(body, (params0, opt.init(params0)))

    params, losses = ff.fit_field(g, mcfg, [tgt], tc)
    rep = ff.fit_report(g, mcfg, params, [tgt])
    row = {
        "ms_per_step": ms,
        "steps": steps,
        "loss_first": float(losses[0]),
        "loss_last": float(losses[-1]),
        "psnr_sigma_db": rep["snapshots"][0]["psnr_sigma_db"],
        "psnr_u_db": rep["snapshots"][0]["psnr_u_db"],
        "compression_ratio": rep["compression_ratio"],
        "param_bytes": rep["param_bytes"],
    }
    print(
        f"fit,{name},{g.nx},{g.ny},{g.nz},{steps},{ms:.4f},"
        f"{row['psnr_sigma_db']:.2f},{row['compression_ratio']:.1f}",
        file=sys.stderr,
    )
    return row


def main() -> None:
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 300
    g = GridSpec(nx=128, ny=96, nz=96, hx=0.05, hy=0.05, hz=0.05, dt=1e-3)
    tgt = make_target(g)
    mcfg = MLPGridConfig(dims=MLPDims(H=128))
    arms = {
        "mlp_h128": bench_family("mlp_h128", g, mcfg, tgt, steps, lr=3e-3),
        "ngp_dense": bench_family(
            "ngp_dense", g, NGPFieldConfig(), tgt, steps, lr=5e-3
        ),
    }
    payload = {
        "metric": "fit_field_flagship",
        "grid": [g.nx, g.ny, g.nz],
        "arms": arms,
    }
    print(json.dumps(payload))


if __name__ == "__main__":
    enable_compile_cache()
    main()
