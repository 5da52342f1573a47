"""Weak-scaling sweep of the sharded fused training step on the CPU mesh.

Grid z-extent grows with the device count (per-device work constant), and
each mesh size runs one timed step. On the virtual CPU mesh all devices
share host cores, so wall time cannot show parallel speedup — what this
validates is the SCALING STRUCTURE: the per-device program (slab count,
collective schedule, memory) stays constant as the mesh grows, so total
1-core wall time should grow ~linearly with total work and per-device peak
memory should stay flat. On a real multi-GPU mesh the same program is the
weak-scaling run proper.

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scripts/weak_scaling.py
"""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from phys_autodiff_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def main():
    jax.config.update("jax_platforms", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    from jax.sharding import Mesh

    from phys_autodiff_tpu.models import mlp
    from phys_autodiff_tpu.parallel.sharded import make_sharded_fused_train_step
    from phys_autodiff_tpu.utils.config import (
        GridSpec,
        MLPDims,
        MLPGridConfig,
        PhysWeights,
    )

    mcfg = MLPGridConfig(dims=MLPDims(H=32))
    w = PhysWeights()
    nz_per_dev = 8
    print("devices available:", len(jax.devices()))
    capture = {"nz_per_dev": nz_per_dev, "arms": {}}
    # The per-shard kernel pair runs in interpret mode on the CPU.
    for arm, dims in (("fused", dict(nx=64, ny=32)),):
        print(f"\n[{arm} step]")
        print("n_dev  nz   cells/dev   ms/step (1-core wall)  ms/step/dev-work")
        base = None
        rows = []
        for n_dev in (1, 2, 4, 8):
            devices = jax.devices()[:n_dev]
            mesh = Mesh(np.asarray(devices), ("z",))
            g = GridSpec(
                nz=nz_per_dev * n_dev, hx=0.1, hy=0.1, hz=0.1, dt=1e-2, **dims
            )
            step, init = make_sharded_fused_train_step(g, w, mcfg, mesh)
            params, opt = init(mlp.init_params(mcfg.dims, seed=0))
            # Per-device memory constancy evidence: XLA's own memory
            # analysis of the compiled per-device program (temp allocations
            # are the field/residual/gradient working set — the quantity
            # that must stay FLAT as the mesh grows for weak scaling to
            # hold on a real mesh).
            mem = None
            try:
                ma = step.lower(params, opt, jnp.float32(0.25)).compile(
                ).memory_analysis()
                mem = {
                    "temp_bytes": int(ma.temp_size_in_bytes),
                    "argument_bytes": int(ma.argument_size_in_bytes),
                    "output_bytes": int(ma.output_size_in_bytes),
                }
            except Exception as e:  # noqa: BLE001 — evidence, not a gate
                print(f"  (memory_analysis unavailable: {e})")
            params, opt, loss = step(params, opt, jnp.float32(0.25))  # compile
            jax.block_until_ready(loss)
            n_it = 3
            t0 = time.perf_counter()
            for _ in range(n_it):
                params, opt, loss = step(params, opt, jnp.float32(0.25))
            loss = float(jax.block_until_ready(loss))
            ms = (time.perf_counter() - t0) / n_it * 1e3
            per_work = ms / n_dev
            if base is None:
                base = per_work
            mem_str = (
                f" temp/dev={mem['temp_bytes'] / 1e6:.1f}MB" if mem else ""
            )
            print(
                f"{n_dev:5d}  {g.nz:3d}  {g.num_cells // n_dev:9d}  "
                f"{ms:10.2f}            {per_work:8.2f}  "
                f"(x{per_work / base:.2f} vs 1-dev; loss={loss:.4f}){mem_str}"
            )
            rows.append({
                "n_dev": n_dev, "nz": g.nz,
                "cells_per_dev": g.num_cells // n_dev,
                "ms_step_wall_1core": round(ms, 3),
                "ms_per_dev_work": round(per_work, 3),
                "ratio_vs_1dev": round(per_work / base, 3),
                "loss": loss, "memory": mem,
            })
        capture["arms"][arm] = rows
    capture["interpretation"] = (
        "virtual 8-device CPU mesh on one core: wall time growing ~linearly "
        "with total work at flat per-device-work time and flat per-device "
        "temp memory is the weak-scaling STRUCTURE a real mesh "
        "inherits (the per-device program is device-count independent; "
        "only the psum participant set grows)"
    )
    import json

    os.makedirs("build", exist_ok=True)
    path = "build/weak_scaling.json"
    with open(path, "w") as f:
        f.write(json.dumps(capture, indent=1) + "\n")
    print(f"wrote {path}")
    print(
        "\nper-device-work time should stay ~flat (structure scales); on a "
        "real multi-GPU mesh this sweep is the weak-scaling measurement "
        "proper."
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
