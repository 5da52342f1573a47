"""Tracer-particle advection through a learned velocity field.

The project north star frames the system's throughput as
"particles * steps / sec"; the reference contains no integrator or particle
of any kind (SURVEY.md §0 — `phys.h` is a residual operator, nothing
advances state). This app closes that framing gap ON TOP of the parity
core: given any trained field model (coordinate MLP, NGP/Fourier encoded
field, or a frozen grid snapshot), advance P tracer particles

    dx/dt = u(x, t)

with explicit Euler or RK2 (midpoint). The whole rollout
is ONE `lax.scan` inside jit — P particles advance in lockstep as [P, 3]
tensor ops (velocity queries are batched model evaluations or batched
trilinear gathers), no host loop, no per-step dispatch.

State lives in continuous grid-INDEX coordinates (models/sample.py) where
the periodic topology has period n per axis; physical velocity converts to
index velocity by 1/h per axis. Boundary handling matches the field
operators: periodic wraps, clamp boxes the particle into [0, n-1].
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

from phys_autodiff_tpu.models import sample
from phys_autodiff_tpu.utils.config import GridSpec, MLPGridConfig


@dataclasses.dataclass(frozen=True)
class AdvectConfig:
    steps: int = 100
    dt: float = 1e-3
    method: str = "rk2"  # "euler" | "rk2" (midpoint)
    record_every: int = 0  # 0: return final positions only;
    # k > 0: also return the [steps//k, P, 3] trajectory (index coords)


# A velocity function maps (pts_idx [P, 3], t scalar) -> u [P, 3] in
# PHYSICAL units (the model's ux/uy/uz channels).
VelocityFn = Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]


def velocity_fn_from_model(g: GridSpec, model_cfg, params, **kw) -> VelocityFn:
    """Velocity from direct model evaluation at the particle positions —
    exact (no interpolation), time-dependent, differentiable through the
    model parameters. model_cfg: MLPGridConfig or NGPFieldConfig (any
    encoder family); kw forwards to sample.evaluate_points.

    Periodic seam band: index space wraps with period n but the model's
    domain is the unit cube with node n-1 at u=1, so indices in (n-1, n)
    have no model coordinate. The unit coords are CLAMPED to [0, 1]: the
    band (width 1 cell in n) evaluates at the u=1 face. This keeps every
    query inside the model's domain (hash encoders alias outside it) at
    the cost of a face-value plateau across the band — a field trained
    with periodic physics couples the u=0/u=1 faces through the wrap
    stencil, so the residual jump is small; use velocity_fn_from_grid
    where exact interpolated wrap behavior matters more than exact
    in-domain values."""

    def vel(pts_idx, t):
        pts_unit = jnp.clip(sample.index_to_unit(g, pts_idx), 0.0, 1.0)
        y = sample.evaluate_points(model_cfg, params, pts_unit, t, **kw)
        return y[..., 1:4]  # [sigma, ux, uy, uz] -> u

    return vel


def velocity_fn_from_grid(g: GridSpec, u_grid: jnp.ndarray) -> VelocityFn:
    """Velocity by trilinear sampling of a FROZEN [3, nz, ny, nx] snapshot
    (channel-major, the physics layout); the time argument is ignored.

    Each query costs 8 scattered corner gathers; velocity_fn_from_model
    re-evaluates the model instead (dense matmuls). Which is faster on a
    given device is a measurement (scripts/advect_bench.py times both);
    on the H100 it is not measured yet. The direct arm needs a model; this
    one serves a field that exists only as grid data, or a query that must
    hit an externally produced snapshot."""
    assert u_grid.shape == (3,) + g.shape, u_grid.shape

    def vel(pts_idx, t):
        del t
        return sample.trilinear_sample(u_grid, pts_idx, g)

    return vel


def _wrap(g: GridSpec, pts_idx: jnp.ndarray) -> jnp.ndarray:
    n = jnp.asarray([g.nx, g.ny, g.nz], dtype=jnp.float32)
    if g.periodic:
        return jnp.mod(pts_idx, n)
    return jnp.clip(pts_idx, 0.0, n - 1.0)


def advect(
    g: GridSpec,
    vel_fn: VelocityFn,
    pts0_idx: jnp.ndarray,
    t0,
    cfg: AdvectConfig,
):
    """Roll P particles forward cfg.steps steps of size cfg.dt.

    pts0_idx: [P, 3] initial positions in grid-index coords (x, y, z).
    Returns final positions [P, 3], or (final, trajectory) when
    cfg.record_every > 0. Call under jax.jit for production use (the scan
    body is a pure function of (positions, step))."""
    inv_h = jnp.asarray(
        [1.0 / g.hx, 1.0 / g.hy, 1.0 / g.hz], dtype=jnp.float32
    )
    dt = jnp.float32(cfg.dt)
    t0 = jnp.float32(t0)
    if cfg.method not in ("euler", "rk2"):
        raise ValueError(f"unknown method {cfg.method!r}")

    def step(pts, k):
        t = t0 + dt * k.astype(jnp.float32)
        v1 = vel_fn(pts, t) * inv_h  # index-space velocity
        if cfg.method == "euler":
            nxt = pts + dt * v1
        else:  # rk2 midpoint
            mid = _wrap(g, pts + 0.5 * dt * v1)
            v2 = vel_fn(mid, t + 0.5 * dt) * inv_h
            nxt = pts + dt * v2
        return _wrap(g, nxt), None

    pts0 = _wrap(g, pts0_idx.astype(jnp.float32))
    ks = jnp.arange(cfg.steps)
    if cfg.record_every and cfg.record_every > 0:
        # chunked scan: record one frame per record_every steps
        assert cfg.steps % cfg.record_every == 0, (
            "steps must be a multiple of record_every"
        )
        inner = cfg.record_every

        def chunk(pts, k0):
            def body(p, j):
                p, _ = step(p, k0 * inner + j)
                return p, None

            pts, _ = jax.lax.scan(body, pts, jnp.arange(inner))
            return pts, pts

        final, frames = jax.lax.scan(
            chunk, pts0, jnp.arange(cfg.steps // inner)
        )
        return final, frames

    def body(p, k):
        return step(p, k)

    final, _ = jax.lax.scan(body, pts0, ks)
    return final


def advect_sharded(
    g: GridSpec,
    vel_fn: VelocityFn,
    pts0_idx: jnp.ndarray,
    t0,
    cfg: AdvectConfig,
    mesh,
    axis: str | None = None,
):
    """Multi-chip advection: particles sharded over the mesh, weights
    replicated — pure data parallelism in its cleanest form.

    Advection is embarrassingly parallel over particles (each trajectory
    depends only on its own position and the replicated field model), so
    no shard_map or collective is needed: annotate the [P, 3] positions
    with a NamedSharding over the given mesh axis (default: the mesh's
    first axis) and jit the SAME advect() — GSPMD partitions the whole
    scan with zero communication. Sharded == single-chip bitwise (pinned
    by tests/test_sample_advect.py, which also asserts the compiled module
    contains no collectives).

    P must divide by the axis size (pad with dummies otherwise). Returns
    the same outputs as advect(), sharded the same way."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as PS

    if axis is None:
        axis = mesh.axis_names[0]
    n = mesh.shape[axis]
    assert pts0_idx.shape[0] % n == 0, (
        f"particle count {pts0_idx.shape[0]} must be divisible by the "
        f"{axis!r}-axis size {n}"
    )
    sh = NamedSharding(mesh, PS(axis))
    pts0 = jax.device_put(pts0_idx, sh)
    return make_advect_fn(g, vel_fn, t0, cfg)(pts0)


def make_advect_fn(g: GridSpec, vel_fn: VelocityFn, t0, cfg: AdvectConfig):
    """Compile-once form: returns the jitted `pts -> advect(...)` rollout
    for repeated calls (new initial positions, same config). Cached per
    (g, vel_fn, t0, cfg) — calling advect_sharded or this helper again
    with the same arguments reuses the executable instead of re-tracing
    and recompiling."""
    key = (g, id(vel_fn), float(t0), cfg)
    hit = _ADVECT_CACHE.get(key)
    if hit is not None and hit[0] is vel_fn:
        # LRU refresh: re-insert so the hot entry is never the eviction
        # victim (grid-snapshot vel_fns each pin ~14 MB of device memory
        # at the flagship grid, and a dropped executable costs a
        # recompile — evict one cold entry, never the working set)
        _ADVECT_CACHE.pop(key)
        _ADVECT_CACHE[key] = hit
        return hit[1]
    fn = jax.jit(lambda p: advect(g, vel_fn, p, t0, cfg))
    if len(_ADVECT_CACHE) >= 64:  # bound growth; evict least recent
        _ADVECT_CACHE.pop(next(iter(_ADVECT_CACHE)))
    # keep vel_fn alive in the entry so its id cannot be recycled onto a
    # different function while the cached executable still closes over it
    _ADVECT_CACHE[key] = (vel_fn, fn)
    return fn


_ADVECT_CACHE: dict = {}
