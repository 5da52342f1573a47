"""Benchmark. Prints ONE JSON line to stdout:

    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "arm": ...,
     "device": {"platform", "kind", "count", "power_limit"}, "roofline": ...}

and the reference-schema CSV rows (phys, mlp_phys, train, big) to stderr.

Headline metric: throughput of the residual op (XLA's fusion of ops/, the
system's one residual arm) at the reference's largest benchmark grid
(128x96x96 = 1,179,648 cells), in grid-cell-iterations/sec. Baseline: the
reference's fused CUDA kernel on an RTX 5090 — 0.11997 ms/iter == 9.833 G
cell-iters/s (BASELINE.md). The roofline share is taken against the
published peaks of bench/peaks.py for the device's kind.

It measures only on a GPU: on any other platform it exits non-zero and
prints no result, so a number from a CPU can never be read as a device
number. Timing: on-device loops ended by block_until_ready
(bench/harness.py).

    python bench.py
"""

import json
import subprocess
import sys

N_CELLS_FLAGSHIP = 128 * 96 * 96
BASELINE_MS = 0.11997  # reference fused CUDA kernel, RTX 5090
BYTES_PER_CELL = 64  # 12 field planes read + 4 residual planes written, f32


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def device_info() -> dict:
    """The device JAX runs on; raises unless it is a GPU."""
    import jax

    d = jax.devices()[0]
    if d.platform != "gpu":
        raise RuntimeError(
            f"bench.py measures on a GPU; JAX found {d.platform!r}"
        )
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "power_limit": power_limit()}


def power_limit() -> str:
    """`name, power.limit` of the card as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def headline(ms: float, device: dict) -> dict:
    """The JSON line for a residual time `ms` at the flagship grid."""
    from phys_autodiff_tpu.bench.peaks import roofline_share

    cells_per_s = N_CELLS_FLAGSHIP / (ms / 1e3)
    roof = roofline_share(ms, N_CELLS_FLAGSHIP * BYTES_PER_CELL,
                          N_CELLS_FLAGSHIP * 30, device["kind"])
    return {
        "metric": "residual_throughput_128x96x96",
        "value": cells_per_s / 1e9,
        "unit": "Gcell_iters_per_s",
        "vs_baseline": BASELINE_MS / ms,
        "arm": "nonfused",
        "ms": ms,
        "device": device,
        "roofline": roof,
    }


def main() -> int:
    device = device_info()

    from phys_autodiff_tpu.bench import bigbench, harness
    from phys_autodiff_tpu.bench.trainbench import (
        bench_ngp_train_step,
        bench_train_step,
    )
    from phys_autodiff_tpu.utils.cache import enable_compile_cache
    from phys_autodiff_tpu.utils.config import GridSpec

    enable_compile_cache()
    log(f"# device: {device}")

    def grid(nx, ny, nz):
        return GridSpec(nx=nx, ny=ny, nz=nz, hx=0.05, hy=0.05, hz=0.05, dt=1e-3)

    flag_ms = None
    log("# phys,variant,nx,ny,nz,iters,ms")
    for dims in harness.REFERENCE_GRIDS:
        for r in harness.bench_phys(grid(*dims)):
            log(r.csv())
            if dims == (128, 96, 96):
                flag_ms = r.ms

    log("# mlp_phys,variant,nx,ny,nz,iters,ms_kernel,ms_phys_e2e,ms_mlp,ms_total")
    for dims in harness.REFERENCE_GRIDS:
        for r in harness.bench_pipeline(grid(*dims)):
            log(r.csv())

    gf = grid(128, 96, 96)
    log("# train,variant,nx,ny,nz,H,ms_step")
    for variant, ms in bench_train_step(gf, h=128).items():
        log(f"train,{variant},{gf.nx},{gf.ny},{gf.nz},128,{ms:.5f}")
    for prec in ("f32", "bf16"):
        ms = bench_ngp_train_step(gf, precision=prec)
        log(f"train,ngp_{prec},{gf.nx},{gf.ny},{gf.nz},-,{ms:.5f}")

    log("# big-grid rows")
    for dims in bigbench.BIG_GRIDS:
        g = grid(*dims)
        for r in bigbench.big_phys_rows(g):
            log(r.csv())
        for variant, ms in bigbench.big_train_ms(g).items():
            log(f"train,{variant},{g.nx},{g.ny},{g.nz},128,{ms:.5f}")

    print(json.dumps(headline(flag_ms, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
