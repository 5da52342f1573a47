"""Benchmark harness reproducing the reference's measurement taxonomy.

The reference measures four scopes per (grid, variant) with warmup=2,
iters=10 (test/test_phys_perf.cpp:74-90, test/test_mlp_phys_perf.cpp:20-81):

    ms_kernel     kernel-only (the residual-writing op)
    ms_phys_e2e   the physics portion as composed in the pipeline
                  (residuals -> loss_terms)
    ms_mlp        MLP field generation (3 time slices)
    ms_total      full pipeline per iteration

CSV schemas match the reference so reports are directly comparable:
    phys,residuals_nonfused,nx,ny,nz,iters,ms
    mlp_phys,nonfused|fused|fused_bf16,nx,ny,nz,iters,ms_kernel,ms_phys_e2e,ms_mlp,ms_total

Timing methodology. Each measurement is an ON-DEVICE lax.fori_loop of
the op, jit-compiled and warmed up, then run for a trip count that fills a
target time and ended by `block_until_ready`: ms/iter is the wall time over
the trip count (the dispatch of one loop is shared by all its iterations).
The loop body must thread a data dependency through the carry, or XLA may
hoist or narrow the op. A naive body that consumes one element of one
output lets XLA dead-code-eliminate most of the stencil (sliced fusions
compute only their root's elements), and `jax.lax.optimization_barrier`
does not prevent that narrowing. The harness therefore uses three
*structurally* DCE-proof modes:

  * GENERATIONAL FEEDBACK (`time_residual_op`, for the XLA-staged residual
    op): the loop carries THREE generations of residual outputs and builds
    all six input fields from them (tm1 <- gen i-2, t <- gen i-1,
    tp1 <- gen i-3-equivalent). Because the outputs ARE the fori_loop carry,
    whose shapes are fixed, XLA must materialize every output at full shape
    every iteration — narrowing is impossible by construction, and nothing
    is loop-invariant. Traffic per iteration: 12 planes read + 4 written =
    64 B/cell, exactly the reference kernel's profile. Outputs are scaled by
    a carried runtime epsilon (fuses into the stencil epilogue, ~zero cost)
    so values decay instead of overflowing.
  * PROBE (`time_op`, for Pallas kernels and scalar pipelines): perturb one
    input element by the carry and fold one element of each output back in.
    Sound for Pallas because a pallas_call is an opaque custom call — XLA
    can neither narrow it nor split it; consuming any output element runs
    the whole kernel. Sound for scalar losses because the scalar depends on
    every cell.
  * REDUCE (`time_op(..., mode="reduce")`, for XLA field generators):
    fold jnp.sum of every output into the carry. Every element is computed;
    XLA may fuse the reduction and skip the output writes, which for this
    compute-bound op skews the number slightly (documented, accepted).

`check_timed_hlo` compiles the exact timed loop and asserts the optimized
HLO retains full-shape ops for the outputs (feedback mode) or the opaque
custom call (probe mode): a timing whose body XLA narrowed is refused.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from phys_autodiff_tpu import ops
from phys_autodiff_tpu.models import fields as fields_mod
from phys_autodiff_tpu.models import mlp
from phys_autodiff_tpu.ops.stencil import FieldSnapshots
from phys_autodiff_tpu.utils.config import (
    GridSpec,
    MLPDims,
    MLPGridConfig,
    PhysWeights,
)

# The reference's benchmark grids (test/test_phys_perf.cpp:74-90).
REFERENCE_GRIDS = [(64, 64, 64), (96, 96, 64), (128, 96, 96)]
DEFAULT_ITERS = 10


def _make_run(body: Callable):
    @jax.jit
    def run(carry, n):
        return jax.lax.fori_loop(0, n, body, carry)

    return run


def time_loop(body: Callable, carry0, target_seconds=0.5, repeats=3):
    """ms per iteration of `body(i, carry) -> carry`: an on-device
    fori_loop, compiled and warmed first, sized to run about
    `target_seconds`, ended by block_until_ready; best of `repeats`."""
    run = _make_run(body)

    def timed(n):
        t0 = time.perf_counter()
        jax.block_until_ready(run(carry0, n))
        return time.perf_counter() - t0

    timed(4)  # compile + warm
    per_iter = max(min(timed(16) for _ in range(repeats)) / 16, 1e-7)
    n = int(min(max(16, target_seconds / per_iter), 200_000))
    return min(timed(n) for _ in range(repeats)) / n * 1e3


def _perturb(arr, acc):
    """Single-element nudge that makes the op depend on the loop carry; the
    dynamic-update-slice is in-place on the loop-carried buffer."""
    return arr.at[(0,) * arr.ndim].add((acc * 1e-30).astype(arr.dtype))


def _op_body(op_fn: Callable, mode: str):
    """Timing-loop body for `op_fn(x) -> pytree of outputs` (see module
    docstring for the mode soundness arguments)."""

    def body(i, carry):
        acc, x = carry
        # Carry the PERTURBED buffer forward: the one-element
        # dynamic-update-slice then aliases in place inside the while loop.
        # (Carrying the unperturbed x would keep both values live and force
        # a full copy of x every iteration — 56 MB/iter for packed fields.)
        x = _perturb(x, acc)
        outs = op_fn(x)
        s = jnp.float32(0.0)
        for leaf in jax.tree_util.tree_leaves(outs):
            if mode == "reduce":
                s = s + jnp.sum(leaf).astype(jnp.float32)
            else:  # probe
                s = s + leaf.reshape(-1)[0].astype(jnp.float32)
        return acc + s * jnp.float32(1e-6), x

    return body


def time_op(op_fn: Callable, x, mode: str = "probe", **kw) -> float:
    """ms/iter of `op_fn(x) -> pytree`. mode: "probe" (Pallas/opaque ops and
    scalar pipelines) or "reduce" (XLA ops whose full output must be forced;
    see module docstring)."""
    return time_loop(_op_body(op_fn, mode), (jnp.float32(0.0), x), **kw)


# ---------------------------------------------------------------------------
# Generational-feedback residual timing (structurally DCE-proof)
# ---------------------------------------------------------------------------


def _residual_feedback_body(res_fn):
    """Loop body: all six input fields are built from the three most recent
    output generations, so every output is a full-shape carry element."""

    def body(i, carry):
        rs_a, ru_a, rs_b, ru_b, rs_c, ru_c, eps = carry
        fields = FieldSnapshots(
            sigma_tm1=rs_c, sigma_t=rs_a, sigma_tp1=rs_b,
            u_tm1=ru_c, u_t=ru_a, u_tp1=ru_b,
        )
        rs, ru = res_fn(fields)
        # Damp with the carried runtime scalar (cannot be constant-folded);
        # fuses into the stencil epilogue.
        return rs * eps, ru * eps, rs_a, ru_a, rs_b, ru_b, eps

    return body


def _residual_feedback_carry(fields: FieldSnapshots):
    # The FIRST leaf is the newest output generation: time_loop fetches
    # leaf 0 as its completion fence, so it must be data-dependent on the
    # whole loop (the loop-invariant eps scalar goes last — as leaf 0 it
    # could in principle unblock before the loop finishes on a runtime
    # with per-buffer readiness).
    return (
        fields.sigma_t, fields.u_t,
        fields.sigma_tp1, fields.u_tp1,
        fields.sigma_tm1, fields.u_tm1,
        jnp.float32(1e-3),
    )


def time_residual_op(res_fn, fields: FieldSnapshots) -> float:
    """ms/iter of a residuals(fields) -> (r_sigma, r_u) op, generational
    feedback mode: 12 planes read + 4 written per iteration, exactly the
    reference kernel's traffic, with materialization forced by the carry.
    """
    return time_loop(
        _residual_feedback_body(res_fn), _residual_feedback_carry(fields)
    )


def check_timed_hlo(
    op_fn: Callable,
    x,
    required: list[str],
    mode: str = "probe",
    fields: FieldSnapshots | None = None,
) -> str:
    """Compile the exact timed loop and assert the optimized HLO retains the
    required signatures (full shapes for feedback mode, the opaque custom
    call for Pallas probe mode). Returns the HLO text.

    Feedback mode asserts each required SHAPE appears as the result type of
    a COMPUTE op (fusion/arithmetic), not merely anywhere in the text — the
    carry shapes always appear in the while-loop parameter signature, so a
    plain substring match would be vacuously true even with the body
    narrowed away."""
    import re

    if mode == "feedback":
        run = _make_run(_residual_feedback_body(op_fn))
        args = (_residual_feedback_carry(fields), jnp.int32(4))
    else:
        run = _make_run(_op_body(op_fn, mode))
        args = ((jnp.float32(0.0), x), jnp.int32(4))
    txt = run.lower(*args).compile().as_text()
    for sig in required:
        is_shape = re.fullmatch(r"\w+\[[\d,]+\]", sig) is not None
        if mode == "feedback" and is_shape:
            pat = re.compile(
                r"= " + re.escape(sig)
                + r"\S*\s+(fusion|add|multiply|subtract|divide|concatenate)\("
            )
            assert pat.search(txt), (
                f"timed HLO has no compute op producing {sig!r} — DCE?"
            )
        else:
            assert sig in txt, (
                f"timed HLO lost required signature {sig!r} — DCE?"
            )
    return txt


def random_fields(g: GridSpec, seed=0) -> FieldSnapshots:
    rng = np.random.default_rng(seed)
    mk = lambda s: jnp.asarray(rng.standard_normal(s), jnp.float32)
    return FieldSnapshots(
        sigma_tm1=mk(g.shape),
        sigma_t=mk(g.shape),
        sigma_tp1=mk(g.shape),
        u_tm1=mk((3,) + g.shape),
        u_t=mk((3,) + g.shape),
        u_tp1=mk((3,) + g.shape),
    )


def time_fieldgen(gen_fn, params, mode: str = "probe") -> float:
    """ms/iter of a generate_fields(params) -> FieldSnapshots op. Use
    mode="reduce" for XLA-staged generators (probe would narrow them);
    "probe" is sound for the Pallas kernel pair."""

    def op(w1):
        p = dict(params)
        p["W1"] = w1
        return gen_fn(p)

    return time_op(op, params["W1"], mode=mode)


def time_scalar_pipeline(loss_fn, params) -> float:
    """ms/iter of a loss(params) -> scalar(s) pipeline (probe mode is sound:
    the scalar depends on every cell)."""

    def op(w1):
        p = dict(params)
        p["W1"] = w1
        return loss_fn(p)

    return time_op(op, params["W1"])


@dataclasses.dataclass
class PhysRow:
    variant: str
    nx: int
    ny: int
    nz: int
    iters: int
    ms: float

    def csv(self) -> str:
        return f"phys,residuals_{self.variant},{self.nx},{self.ny},{self.nz},{self.iters},{self.ms:.5f}"


@dataclasses.dataclass
class PipelineRow:
    variant: str
    nx: int
    ny: int
    nz: int
    iters: int
    ms_kernel: float
    ms_phys_e2e: float
    ms_mlp: float
    ms_total: float

    def csv(self) -> str:
        return (
            f"mlp_phys,{self.variant},{self.nx},{self.ny},{self.nz},{self.iters},"
            f"{self.ms_kernel:.5f},{self.ms_phys_e2e:.5f},{self.ms_mlp:.5f},"
            f"{self.ms_total:.5f}"
        )


def bench_phys(g: GridSpec, iters=DEFAULT_ITERS) -> list:
    """Physics residuals only (port of test_phys_perf): the XLA-staged op,
    the system's one residual arm."""
    fs = random_fields(g)
    ms = time_residual_op(lambda x: ops.residuals(g, x), fs)
    return [PhysRow("nonfused", g.nx, g.ny, g.nz, iters, ms)]


def bench_pipeline(g: GridSpec, h=128, iters=DEFAULT_ITERS, seed=777) -> list:
    """Full MLP+physics pipeline (port of test_mlp_phys_perf: H=128, seed
    777, 3 grid evals per physics step). Rows: "nonfused" generates the
    fields with the plain XLA MLP, "fused"/"fused_bf16" with the kernel
    pair of pallas/fieldgen.py; the physics scopes are the same XLA
    residual and loss ops in every row, so the rows differ in ms_mlp and
    ms_total only.
    """
    from phys_autodiff_tpu.pallas import fieldgen

    cfg = MLPGridConfig(dims=MLPDims(H=h))
    params = mlp.init_params(cfg.dims, seed=seed)
    w = PhysWeights()
    fs = random_fields(g)

    ms_kernel = time_residual_op(lambda x: ops.residuals(g, x), fs)
    # Physics-as-composed scope: ends in a scalar, probe mode is sound.
    ms_phys = time_op(
        lambda s: ops.loss_terms(g, w, *ops.residuals(g, fs._replace(sigma_t=s))),
        fs.sigma_t,
    )
    gens = {
        "nonfused": lambda p: fields_mod.generate_fields(g, cfg, p, 0.25, g.dt),
        "fused": lambda p: fieldgen.generate_fields(g, cfg, p, 0.25, g.dt),
        "fused_bf16": lambda p: fieldgen.generate_fields(
            g, cfg, p, 0.25, g.dt, "bf16"
        ),
    }
    rows = []
    for variant, gen in gens.items():
        mode = "reduce" if variant == "nonfused" else "probe"
        rows.append(
            PipelineRow(
                variant, g.nx, g.ny, g.nz, iters,
                ms_kernel=ms_kernel, ms_phys_e2e=ms_phys,
                ms_mlp=time_fieldgen(gen, params, mode=mode),
                ms_total=time_scalar_pipeline(
                    lambda p, gen=gen: ops.total_loss(g, w, gen(p)), params
                ),
            )
        )
    return rows


def run_all(iters=DEFAULT_ITERS, grids=None, h=128, pipeline_grids=None):
    """Full suite; returns (phys_rows, pipeline_rows)."""
    grids = grids or REFERENCE_GRIDS
    pipeline_grids = pipeline_grids or grids
    phys_rows, pipe_rows = [], []
    for nx, ny, nz in grids:
        g = GridSpec(nx=nx, ny=ny, nz=nz, hx=0.05, hy=0.05, hz=0.05, dt=1e-3)
        phys_rows += bench_phys(g)
    for nx, ny, nz in pipeline_grids:
        g = GridSpec(nx=nx, ny=ny, nz=nz, hx=0.05, hy=0.05, hz=0.05, dt=1e-3)
        pipe_rows += bench_pipeline(g, h=h)
    return phys_rows, pipe_rows
