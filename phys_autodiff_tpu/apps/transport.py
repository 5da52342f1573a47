"""Semi-Lagrangian scalar transport on the grid — gather-free.

The classic unconditionally-stable advection step: to advance sigma by dt
through velocity u, backtrace each cell's characteristic to its departure
point x_d = x - u(x) dt and interpolate sigma there. Textbook
implementations gather 8 arbitrary corners per cell. This module exploits
the CFL condition instead: with |u| dt <= h per axis, every departure
point lies within the +-1-neighbor ring, so trilinear interpolation
factorizes into three axis-sweeps of neighbour reads that XLA fuses into
streaming loops (scripts/transport_bench.py times it against the gather
formulation of the same math; on the H100 not measured yet). The sweep
form is

    lerp(f_lo, f_hi, w)   with  f_lo/f_hi chosen from {shift -1, 0, +1}

— nine shifted copies total, all `jnp.roll`-class ops with elementwise
selects, zero gathers, everything fused by XLA. Boundary semantics reuse
the stencil's shift() (periodic wrap / edge clamp), so transport and the
physics residual agree on topology by construction.

Supports time integration of the density the PINN loss is about: the
advection term of R_sigma (SURVEY.md §0: dt sigma + u . grad sigma + ...)
is exactly what one step of this operator applies. No reference analogue
(the reference never advances state in time — survey §0 "no integrator").

Interpolation is MONOTONE (a convex combination of neighbor values), so
the discrete max principle holds: min(f) <= step(f) <= max(f) — pinned by
tests.

Accuracy note: the separable sweeps apply each cell's own per-axis offset
(dimensional splitting). For spatially CONSTANT u this is exactly the
trilinear interpolation at the departure point (tested against the gather
path); for varying u the cross terms differ from unsplit trilinear by
O(dt^2 grad u) — the same order as the backtrace x - u(x) dt itself, so
the split costs no formal order.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from phys_autodiff_tpu.ops.stencil import shift
from phys_autodiff_tpu.utils.config import GridSpec


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    dt: float = 1e-3
    steps: int = 1
    check_cfl: bool = True  # add a checkify-free runtime clamp: offsets
    # are clipped into [-1, 1] cells; with check_cfl the step also returns
    # the pre-clip max offset so callers can assert CFL <= 1
    scheme: str = "semi_lagrangian"  # "semi_lagrangian" | "maccormack"
    mc_limit: bool = True  # clamp the MacCormack correction into the
    # neighbor-ring bounds (keeps the discrete max principle)


def _axis_lerp(f: jnp.ndarray, d: jnp.ndarray, axis: int, periodic: bool):
    """Interpolate f at (index - d) along `axis`, d in [-1, 1] cells.

    Departure offset d means value at i - d. For d >= 0 the bracketing
    nodes are i-1 and i (weight d on i-1); for d < 0 they are i and i+1
    (weight -d on i+1). Implemented as one select over the three shifted
    copies — a convex combination for |d| <= 1 (monotone)."""
    f_m = shift(f, -1, axis, periodic)  # value at i-1
    f_p = shift(f, +1, axis, periodic)  # value at i+1
    w = jnp.abs(d)
    nbr = jnp.where(d >= 0, f_m, f_p)
    return f + w * (nbr - f)


def transport_step(
    g: GridSpec, sigma: jnp.ndarray, u: jnp.ndarray, dt
) -> jnp.ndarray:
    """One semi-Lagrangian step: sigma(x, t+dt) = sigma(x - u dt, t) with
    gather-free separable trilinear interpolation (CFL <= 1: offsets are
    clipped to one cell per axis). sigma [nz, ny, nx]; u [3, nz, ny, nx]
    (the framework's channel-major physics layout)."""
    assert u.shape == (3,) + sigma.shape, (u.shape, sigma.shape)
    dt = jnp.float32(dt)
    per = g.periodic
    # per-axis departure offsets in CELLS, clipped to the one-cell ring
    dx = jnp.clip(u[0] * (dt / g.hx), -1.0, 1.0)
    dy = jnp.clip(u[1] * (dt / g.hy), -1.0, 1.0)
    dz = jnp.clip(u[2] * (dt / g.hz), -1.0, 1.0)
    # separable sweeps: x (axis 2), then y (axis 1), then z (axis 0)
    out = _axis_lerp(sigma, dx, 2, per)
    out = _axis_lerp(out, dy, 1, per)
    out = _axis_lerp(out, dz, 0, per)
    return out


def transport_step_bf16(
    g: GridSpec, sigma: jnp.ndarray, u: jnp.ndarray, dt
) -> jnp.ndarray:
    """bf16-I/O tier of transport_step: sigma and u live in HBM as
    bfloat16, the sweeps run bf16 arithmetic, and the result comes back
    bfloat16 — the step is measured bandwidth-bound at ~1 TB/s effective
    (module docstring), so halving every stream's bytes is the one lever
    scheduling cannot reach. Departure offsets are computed in f32 from
    the upcast velocity (offset precision is the accuracy-critical part:
    an f32 offset from a bf16 velocity carries only the velocity's own
    ~4e-3 relative error, not additional interpolation error); the lerp
    weights then round to bf16, so each sweep is a convex combination in
    bf16 — the discrete max principle holds to bf16 rounding (~4e-3
    relative), and total error vs the f32 step is 1e-2-class (tested).
    Same doctrine as the bf16 point-serving tier (models/sample.py)."""
    assert u.shape == (3,) + sigma.shape, (u.shape, sigma.shape)
    bf16 = jnp.bfloat16
    sigma = sigma.astype(bf16)
    u = u.astype(bf16)
    dt = jnp.float32(dt)
    per = g.periodic
    dx = jnp.clip(u[0].astype(jnp.float32) * (dt / g.hx), -1.0, 1.0)
    dy = jnp.clip(u[1].astype(jnp.float32) * (dt / g.hy), -1.0, 1.0)
    dz = jnp.clip(u[2].astype(jnp.float32) * (dt / g.hz), -1.0, 1.0)

    def axis_lerp_bf16(f, d, axis):
        f_m = shift(f, -1, axis, per)
        f_p = shift(f, +1, axis, per)
        w = jnp.abs(d).astype(bf16)
        nbr = jnp.where(d >= 0, f_m, f_p)
        return f + w * (nbr - f)

    out = axis_lerp_bf16(sigma, dx, 2)
    out = axis_lerp_bf16(out, dy, 1)
    out = axis_lerp_bf16(out, dz, 0)
    return out


def _axis_lerp_many(f, d, axis, periodic):
    """_axis_lerp for a [C, nz, ny, nx] batch of scalars sharing ONE
    offset field d [nz, ny, nx]; `axis` in field coords (0=z,1=y,2=x)."""
    f_m = shift(f, -1, axis + 1, periodic)
    f_p = shift(f, +1, axis + 1, periodic)
    w = jnp.abs(d)[None]
    nbr = jnp.where((d >= 0)[None], f_m, f_p)
    return f + w * (nbr - f)


def transport_step_many(
    g: GridSpec, fields: jnp.ndarray, u: jnp.ndarray, dt
) -> jnp.ndarray:
    """Advect a [C, nz, ny, nx] BATCH of scalars through one velocity
    field in a single pass. Bitwise equal per channel to transport_step
    (pinned by tests); batching shares the offset computation and runs
    every shift/select/lerp on [C, ...] blocks, so XLA fuses one chain
    instead of three. Used by the Euler stepper's velocity self-advection
    (apps/euler.py)."""
    assert fields.ndim == 4 and u.shape == (3,) + fields.shape[1:], (
        fields.shape, u.shape)
    dt = jnp.float32(dt)
    per = g.periodic
    dx = jnp.clip(u[0] * (dt / g.hx), -1.0, 1.0)
    dy = jnp.clip(u[1] * (dt / g.hy), -1.0, 1.0)
    dz = jnp.clip(u[2] * (dt / g.hz), -1.0, 1.0)
    out = _axis_lerp_many(fields, dx, 2, per)
    out = _axis_lerp_many(out, dy, 1, per)
    out = _axis_lerp_many(out, dz, 0, per)
    return out


def maccormack_step_many(
    g: GridSpec,
    fields: jnp.ndarray,
    u: jnp.ndarray,
    dt,
    *,
    limit: bool = True,
) -> jnp.ndarray:
    """maccormack_step for a [C, nz, ny, nx] batch (see
    transport_step_many for why batching matters)."""
    fwd = transport_step_many(g, fields, u, dt)
    bwd = transport_step_many(g, fwd, u, -dt)
    out = fwd + 0.5 * (fields - bwd)
    if limit:
        lo, hi = _ring_bounds(fields, g.periodic, axes=(3, 2, 1))
        out = jnp.clip(out, lo, hi)
    return out


def _ring_bounds(f: jnp.ndarray, periodic: bool, axes=(2, 1, 0)):
    """(min, max) of f over each cell's 3x3x3 neighbor ring — computed as
    separable one-axis reductions (erosion/dilation) over `axes`, zero
    gathers. THE one implementation of the MacCormack limiter's bound
    (every step flavor calls it; min/max reductions commute, so axis
    order is immaterial).

    Under CFL <= 1 the split semi-Lagrangian interpolation at cell i only
    ever reads {i-1, i, i+1} per axis, so this ring is exactly the convex
    hull of values one transport step can draw from — the conservative
    clamp bound for the MacCormack correction (Selle et al. 2008's limiter
    re-derived for the gather-free sweeps)."""
    lo = hi = f
    for ax in axes:
        lo = jnp.minimum(
            jnp.minimum(shift(lo, -1, ax, periodic), lo),
            shift(lo, +1, ax, periodic),
        )
        hi = jnp.maximum(
            jnp.maximum(shift(hi, -1, ax, periodic), hi),
            shift(hi, +1, ax, periodic),
        )
    return lo, hi


def _ring_bounds_halo_z(
    f: jnp.ndarray, periodic: bool, xy_axes, halo_axis: int
):
    """_ring_bounds for a z-sharded local slab: x/y reductions are
    shard-local (`xy_axes`), the z reduction rides the 2-plane ppermute
    halo along `halo_axis` — identical values per cell to the single-chip
    bounds (the bitwise sharded==single parity rests on this)."""
    from phys_autodiff_tpu.parallel.sharded import _halo_extend_z

    lo, hi = _ring_bounds(f, periodic, xy_axes)
    lo_e = _halo_extend_z(lo, periodic, axis=halo_axis)
    hi_e = _halo_extend_z(hi, periodic, axis=halo_axis)
    lo = jnp.minimum(
        jnp.minimum(
            jax.lax.slice_in_dim(lo_e, 0, lo_e.shape[halo_axis] - 2,
                                 axis=halo_axis),
            jax.lax.slice_in_dim(lo_e, 1, lo_e.shape[halo_axis] - 1,
                                 axis=halo_axis),
        ),
        jax.lax.slice_in_dim(lo_e, 2, lo_e.shape[halo_axis],
                             axis=halo_axis),
    )
    hi = jnp.maximum(
        jnp.maximum(
            jax.lax.slice_in_dim(hi_e, 0, hi_e.shape[halo_axis] - 2,
                                 axis=halo_axis),
            jax.lax.slice_in_dim(hi_e, 1, hi_e.shape[halo_axis] - 1,
                                 axis=halo_axis),
        ),
        jax.lax.slice_in_dim(hi_e, 2, hi_e.shape[halo_axis],
                             axis=halo_axis),
    )
    return lo, hi


def maccormack_step(
    g: GridSpec,
    sigma: jnp.ndarray,
    u: jnp.ndarray,
    dt,
    *,
    limit: bool = True,
) -> jnp.ndarray:
    """One second-order MacCormack (BFECC-family) advection step.

    Plain semi-Lagrangian advection is first-order: the lerp smears a
    translated profile by O(h) per step. MacCormack estimates that error by
    advecting forward then BACKWARD through the same field —

        fwd  = A_dt(sigma)         (transport_step)
        bwd  = A_{-dt}(fwd)        (the same operator, reversed)
        out  = fwd + (sigma - bwd) / 2

    For exact advection bwd == sigma and the correction vanishes; to
    leading order (sigma - bwd)/2 cancels the lerp's dissipation error,
    giving second-order accuracy in smooth regions (Selle, Fedkiw, Kim,
    Liu, Rossignac 2008). The correction is NOT monotone, so with
    limit=True (default) the result is clamped into the 3x3x3 neighbor-ring
    bounds (`_ring_bounds`) — restoring the discrete max principle while
    keeping second order in smooth regions (the clamp is inactive where the
    field is smooth). Costs exactly 2x transport_step plus 12 elementwise
    min/max sweeps — still zero gathers, everything XLA-fusable.
    """
    fwd = transport_step(g, sigma, u, dt)
    bwd = transport_step(g, fwd, u, -dt)
    out = fwd + 0.5 * (sigma - bwd)
    if limit:
        lo, hi = _ring_bounds(sigma, g.periodic)
        out = jnp.clip(out, lo, hi)
    return out


def make_step(g: GridSpec, cfg: TransportConfig):
    """step(sigma, u, dt) -> sigma for cfg.scheme (the rollout kernels
    dispatch through this so every entry point serves both schemes)."""
    if cfg.scheme == "semi_lagrangian":
        return lambda s, u, dt: transport_step(g, s, u, dt)
    if cfg.scheme == "maccormack":
        return lambda s, u, dt: maccormack_step(
            g, s, u, dt, limit=cfg.mc_limit
        )
    raise ValueError(f"unknown transport scheme {cfg.scheme!r}")


def make_step_many(g: GridSpec, cfg: TransportConfig):
    """Batched [C, nz, ny, nx] counterpart of make_step — the single-chip
    multi-scalar dispatch (shard-local flavor: make_shard_local_step_many).
    All scheme dispatches live in this module so a new scheme has exactly
    these entry points to extend."""
    if cfg.scheme == "semi_lagrangian":
        return lambda fs, u, dt: transport_step_many(g, fs, u, dt)
    if cfg.scheme == "maccormack":
        return lambda fs, u, dt: maccormack_step_many(
            g, fs, u, dt, limit=cfg.mc_limit
        )
    raise ValueError(f"unknown transport scheme {cfg.scheme!r}")


def max_cfl(g: GridSpec, u: jnp.ndarray, dt) -> jnp.ndarray:
    """max_axis |u| dt / h — the step is interpolation-exact only when
    this is <= 1 (beyond that offsets clip and the solution lags)."""
    dt = jnp.float32(dt)
    return jnp.maximum(
        jnp.max(jnp.abs(u[0])) * dt / g.hx,
        jnp.maximum(
            jnp.max(jnp.abs(u[1])) * dt / g.hy,
            jnp.max(jnp.abs(u[2])) * dt / g.hz,
        ),
    )


def transport(
    g: GridSpec,
    sigma0: jnp.ndarray,
    u: jnp.ndarray,
    cfg: TransportConfig,
):
    """Roll sigma forward cfg.steps steps through a FROZEN velocity field
    as one lax.scan (call under jit). Returns (sigma_final, max_cfl_seen);
    assert max_cfl_seen <= 1 for an interpolation-exact rollout."""
    cfl = max_cfl(g, u, cfg.dt)
    step = make_step(g, cfg)

    def body(s, _):
        return step(s, u, cfg.dt), None

    out, _ = jax.lax.scan(body, sigma0, None, length=cfg.steps)
    return out, cfl


def shard_local_transport_step(g: GridSpec):
    """Build the per-shard semi-Lagrangian step for a z-sharded mesh:
    step(s_local [nz/n, ny, nx], u_local [3, nz/n, ny, nx], dt) -> s_local.

    x/y sweeps are shard-local; the z sweep lerps against a 2-plane
    ppermute halo (parallel.sharded._halo_extend_z). Identical arithmetic
    per cell to `transport_step`, so sharded == single-chip BITWISE. Call
    INSIDE shard_map over the Z_AXIS mesh (used by transport_sharded and
    the sharded Euler step, apps/euler.py)."""
    from phys_autodiff_tpu.parallel.sharded import _halo_extend_z

    per = g.periodic

    def step(s, ul, dt):
        dt = jnp.float32(dt)
        dx = jnp.clip(ul[0] * (dt / g.hx), -1.0, 1.0)
        dy = jnp.clip(ul[1] * (dt / g.hy), -1.0, 1.0)
        dz = jnp.clip(ul[2] * (dt / g.hz), -1.0, 1.0)
        out = _axis_lerp(s, dx, 2, per)
        out = _axis_lerp(out, dy, 1, per)
        # z sweep against the halo-extended slab (2 ppermuted planes)
        ext = _halo_extend_z(out, per)
        f_m, f, f_p = ext[:-2], ext[1:-1], ext[2:]
        w = jnp.abs(dz)
        nbr = jnp.where(dz >= 0, f_m, f_p)
        return f + w * (nbr - f)

    return step


def shard_local_maccormack_step(g: GridSpec, *, limit: bool = True):
    """Per-shard MacCormack step for a z-sharded mesh — the fwd/bwd passes
    are `shard_local_transport_step` (each exchanges its own 2-plane z
    halo), and the limiter's z ring reduction runs against the same halo,
    so the arithmetic per cell is identical to `maccormack_step` and
    sharded == single-chip BITWISE (pinned by tests)."""
    per = g.periodic
    tstep = shard_local_transport_step(g)

    def step(s, ul, dt):
        fwd = tstep(s, ul, dt)
        bwd = tstep(fwd, ul, -dt)
        out = fwd + 0.5 * (s - bwd)
        if limit:
            lo, hi = _ring_bounds_halo_z(s, per, xy_axes=(2, 1),
                                         halo_axis=0)
            out = jnp.clip(out, lo, hi)
        return out

    return step


def shard_local_transport_step_many(g: GridSpec):
    """Batched shard-local transport: step(fields [C, nz/n, ny, nx],
    u_local [3, nz/n, ny, nx], dt) — transport_step_many for z-sharded
    slabs (x/y sweeps local, z sweep against the axis=1 halo extension).
    Bitwise equal per channel to shard_local_transport_step."""
    from phys_autodiff_tpu.parallel.sharded import _halo_extend_z

    per = g.periodic

    def step(fs, ul, dt):
        dt = jnp.float32(dt)
        dx = jnp.clip(ul[0] * (dt / g.hx), -1.0, 1.0)
        dy = jnp.clip(ul[1] * (dt / g.hy), -1.0, 1.0)
        dz = jnp.clip(ul[2] * (dt / g.hz), -1.0, 1.0)
        out = _axis_lerp_many(fs, dx, 2, per)
        out = _axis_lerp_many(out, dy, 1, per)
        ext = _halo_extend_z(out, per, axis=1)
        f_m, f, f_p = ext[:, :-2], ext[:, 1:-1], ext[:, 2:]
        w = jnp.abs(dz)[None]
        nbr = jnp.where((dz >= 0)[None], f_m, f_p)
        return f + w * (nbr - f)

    return step


def shard_local_maccormack_step_many(g: GridSpec, *, limit: bool = True):
    """Batched shard-local MacCormack (see maccormack_step_many); the
    limiter's z ring reduction rides the same axis=1 halo."""
    per = g.periodic
    tstep = shard_local_transport_step_many(g)

    def step(fs, ul, dt):
        fwd = tstep(fs, ul, dt)
        bwd = tstep(fwd, ul, -dt)
        out = fwd + 0.5 * (fs - bwd)
        if limit:
            lo, hi = _ring_bounds_halo_z(fs, per, xy_axes=(3, 2),
                                         halo_axis=1)
            out = jnp.clip(out, lo, hi)
        return out

    return step


def make_shard_local_step_many(g: GridSpec, cfg: TransportConfig):
    """Shard-local analogue of the batched dispatch."""
    if cfg.scheme == "semi_lagrangian":
        return shard_local_transport_step_many(g)
    if cfg.scheme == "maccormack":
        return shard_local_maccormack_step_many(g, limit=cfg.mc_limit)
    raise ValueError(f"unknown transport scheme {cfg.scheme!r}")


def make_shard_local_step(g: GridSpec, cfg: TransportConfig):
    """Shard-local analogue of `make_step` (same dispatch contract)."""
    if cfg.scheme == "semi_lagrangian":
        return shard_local_transport_step(g)
    if cfg.scheme == "maccormack":
        return shard_local_maccormack_step(g, limit=cfg.mc_limit)
    raise ValueError(f"unknown transport scheme {cfg.scheme!r}")


def transport_sharded(
    g: GridSpec,
    sigma0: jnp.ndarray,
    u: jnp.ndarray,
    cfg: TransportConfig,
    mesh,
):
    """Multi-chip rollout: sigma and u z-sharded over the mesh's z axis.

    The x/y sweeps are shard-local; only the final z sweep needs neighbor
    data, so each step exchanges exactly TWO boundary planes per shard via
    ppermute (parallel.sharded._halo_extend_z — the same halo the sharded
    residual kernels ride) and lerps against the extended slab. Identical
    arithmetic per cell to transport_step, so sharded == single-chip
    BITWISE (pinned by tests/test_transport.py).

    Returns (sigma_final [nz, ny, nx] z-sharded, max_cfl)."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from phys_autodiff_tpu.parallel.mesh import Z_AXIS

    n = mesh.shape[Z_AXIS]
    assert g.nz % n == 0, (g.nz, n)
    local_step = make_shard_local_step(g, cfg)

    def local_roll(s_local, u_local):
        def body(s, _):
            return local_step(s, u_local, cfg.dt), None

        out, _ = jax.lax.scan(body, s_local, None, length=cfg.steps)
        return out

    rolled = jax.shard_map(
        local_roll,
        mesh=mesh,
        in_specs=(P(Z_AXIS), P(None, Z_AXIS)),
        out_specs=P(Z_AXIS),
        check_vma=False,
    )
    zsh = NamedSharding(mesh, P(Z_AXIS))
    vsh = NamedSharding(mesh, P(None, Z_AXIS))
    sigma0 = jax.device_put(sigma0, zsh)
    u = jax.device_put(u, vsh)
    out = jax.jit(rolled)(sigma0, u)
    return out, max_cfl(g, u, cfg.dt)


def velocity_grid_fn_from_model(g: GridSpec, model_cfg, params):
    """`vel_at(t) -> [3, nz, ny, nx]` source for transport_time_dependent
    from any trained field model (MLP or encoded family): one grid
    inference per step, channels moved to the physics layout."""
    from phys_autodiff_tpu.models.sample import grid_infer_any

    def vel_at(t):
        y = grid_infer_any(g, model_cfg, params, t)
        return jnp.moveaxis(y[..., 1:4], -1, 0)

    return vel_at


def transport_time_dependent(
    g: GridSpec,
    sigma0: jnp.ndarray,
    vel_at: "callable",
    t0,
    cfg: TransportConfig,
):
    """Like transport() but with a time-dependent velocity source
    `vel_at(t) -> [3, nz, ny, nx]` (e.g. a trained model's
    generate_fields / grid_infer slice) evaluated once per step inside
    the scan."""
    dt = jnp.float32(cfg.dt)
    t0 = jnp.float32(t0)
    step = make_step(g, cfg)

    def body(s, k):
        u = vel_at(t0 + dt * k.astype(jnp.float32))
        return step(s, u, cfg.dt), max_cfl(g, u, cfg.dt)

    out, cfls = jax.lax.scan(body, sigma0, jnp.arange(cfg.steps))
    return out, jnp.max(cfls)
