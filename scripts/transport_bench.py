"""Semi-Lagrangian transport throughput: split (gather-free) vs gather.

Times one transport step of the flagship 128x96x96 grid through a frozen
random CFL-0.8 velocity field, two formulations of the SAME math:

  split   apps/transport.transport_step — axis-separable roll+select
          trilinear (no gathers)
  gather  models/sample.trilinear_sample at the per-cell departure points
          (the textbook/GPU formulation; for constant-per-cell offsets the
          two agree to fp rounding — tests/test_transport.py)

Timing: bench.harness.time_loop with the sigma field as the loop carry
(each step consumes the previous output — nothing can be DCE'd or
hoisted). Usage: python scripts/transport_bench.py [arm ...]
(no args = every arm; name arms to time a subset, e.g.
`transport_bench.py split split_bf16`)
"""

from __future__ import annotations

import json
import sys

import jax.numpy as jnp
import numpy as np

from phys_autodiff_tpu.apps import transport as tr
from phys_autodiff_tpu.bench.harness import time_loop
from phys_autodiff_tpu.models import sample
from phys_autodiff_tpu.utils.cache import enable_compile_cache
from phys_autodiff_tpu.utils.config import GridSpec


def main() -> None:
    g = GridSpec(nx=128, ny=96, nz=96, hx=0.05, hy=0.05, hz=0.05, dt=1e-3)
    rng = np.random.default_rng(0)
    sigma0 = jnp.asarray(rng.normal(size=g.shape).astype(np.float32))
    # CFL ~ 0.8 random velocity
    u = jnp.asarray(
        (rng.uniform(-0.8, 0.8, size=(3,) + g.shape)
         * np.array([g.hx, g.hy, g.hz])[:, None, None, None] / g.dt
         ).astype(np.float32)
    )

    # gather-arm departure points are constant (frozen u): precompute the
    # per-cell index coordinates ONCE so both arms time only the per-step
    # work (the split arm recomputes its offsets in-kernel each step —
    # included, elementwise, cheap)
    iz, iy, ix = np.meshgrid(
        np.arange(g.nz), np.arange(g.ny), np.arange(g.nx), indexing="ij"
    )
    base = np.stack([ix, iy, iz], axis=-1).reshape(-1, 3).astype(np.float32)
    off = np.moveaxis(np.asarray(u), 0, -1).reshape(-1, 3) * g.dt
    off /= np.array([g.hx, g.hy, g.hz])
    dep = jnp.asarray(base - off)

    arms = {}

    def split_body(i, s):
        return tr.transport_step(g, s, u, g.dt)

    def gather_body(i, s):
        return sample.trilinear_sample(s, dep, g).reshape(g.shape)

    # bf16-I/O tier: bf16 sigma carry + bf16 velocity (the step is
    # bandwidth-bound, so halved streams are the lever; offsets still
    # compute in f32 inside — apps/transport.transport_step_bf16)
    u_bf16 = u.astype(jnp.bfloat16)
    sigma0_bf16 = sigma0.astype(jnp.bfloat16)

    def split_bf16_body(i, s):
        return tr.transport_step_bf16(g, s, u_bf16, g.dt)

    wanted = set(sys.argv[1:])
    for name, body, init in (
        ("split", split_body, sigma0),
        ("split_bf16", split_bf16_body, sigma0_bf16),
        ("gather", gather_body, sigma0),
    ):
        if wanted and name not in wanted:
            continue
        ms = time_loop(body, init)
        arms[name] = {
            "ms_per_step": ms,
            "gcells_per_s": g.num_cells / (ms * 1e-3) / 1e9,
        }
        print(
            f"transport,{name},{g.nx},{g.ny},{g.nz},{ms:.4f},"
            f"{arms[name]['gcells_per_s']:.3f}",
            file=sys.stderr,
        )

    out = {
        "metric": "transport_cells_steps_per_sec",
        "grid": [g.nx, g.ny, g.nz],
        "arms": arms,
    }
    if "gather" in arms and "split" in arms:
        out["split_over_gather"] = (
            arms["gather"]["ms_per_step"] / arms["split"]["ms_per_step"]
        )
    print(json.dumps(out))


if __name__ == "__main__":
    enable_compile_cache()
    main()
