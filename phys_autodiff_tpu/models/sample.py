"""Arbitrary-point field evaluation — the serving surface.

The reference can only evaluate its model on the full regular grid
(mlp_grid_infer_*, src/mlp_grid.cpp:53-67); there is no API to query the
learned field at arbitrary locations. This module adds that capability for
every model family the framework trains (coordinate MLP, NGP hash field,
Fourier field, and any registered encoder family), plus a trilinear
grid-sampling path for consumers that want many cheap queries against a
frozen field snapshot.

Coordinate conventions (one place, documented once):

  * UNIT coords: `u in [0, 1]^3`, channel order (x, y, z) — the encoder
    convention, and exactly the MLP's ZeroToOne axis coordinate
    `u = i / (n - 1)` (models/coords.py:_axis_coord). Grid node (ix,iy,iz)
    sits at `u = (ix/(nx-1), iy/(ny-1), iz/(nz-1))`.
  * INDEX coords: `f = u * (n - 1)` per axis — continuous grid indices, the
    natural space for interpolation and particle advection (the periodic
    topology has period n there: node index n wraps to 0 at physical
    spacing h per step).

Everything here is pure jnp and jit/vmap/grad-composable: direct model
evaluation is differentiable in the model parameters AND in the query
points; trilinear sampling is differentiable in the sampled values and in
the points (piecewise-linearly).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from phys_autodiff_tpu.models import mlp
from phys_autodiff_tpu.utils.config import CoordNorm, GridSpec, MLPGridConfig


def unit_to_index(g: GridSpec, pts_unit: jnp.ndarray) -> jnp.ndarray:
    """[..., 3] unit-cube coords -> continuous grid-index coords (x, y, z)."""
    scale = jnp.asarray(
        [max(g.nx - 1, 1), max(g.ny - 1, 1), max(g.nz - 1, 1)],
        dtype=jnp.float32,
    )
    return pts_unit.astype(jnp.float32) * scale


def index_to_unit(g: GridSpec, pts_idx: jnp.ndarray) -> jnp.ndarray:
    """Inverse of unit_to_index (degenerate axes map index 0 -> unit 0)."""
    scale = jnp.asarray(
        [max(g.nx - 1, 1), max(g.ny - 1, 1), max(g.nz - 1, 1)],
        dtype=jnp.float32,
    )
    return pts_idx.astype(jnp.float32) / scale


def point_coords(
    pts_unit: jnp.ndarray, t, norm: CoordNorm = CoordNorm.MinusOneToOne
) -> jnp.ndarray:
    """MLP input coords [..., 4] for unit-cube points at time t.

    Applies the same normalization as the grid path (models/coords.py),
    INCLUDING the reference's time quirk (raw t for MinusOneToOne, t + 0.5
    for ZeroToOne — src/mlp_grid.cpp:38), so a point placed exactly on a
    grid node reproduces that node's grid_coords row bit-for-bit."""
    pts_unit = pts_unit.astype(jnp.float32)
    if norm == CoordNorm.MinusOneToOne:
        spatial = 2.0 * pts_unit - 1.0
        t_val = jnp.float32(t)
    else:
        spatial = pts_unit
        t_val = jnp.float32(t) + 0.5
    t_chan = jnp.broadcast_to(t_val, pts_unit.shape[:-1] + (1,))
    return jnp.concatenate([spatial, t_chan], axis=-1)


def mlp_eval_points(
    cfg: MLPGridConfig,
    params: mlp.Params,
    pts_unit: jnp.ndarray,
    t,
    precision: str = "f32",
) -> jnp.ndarray:
    """Coordinate-MLP field at arbitrary unit-cube points: [..., Out].

    precision="f32" (default): at grid nodes this matches
    models.fields.grid_infer exactly (same coordinate rows, same
    pinned-precision matmuls). precision="bf16": bf16 matmul operands
    with f32 accumulation — the framework's standard mixed tier
    (1e-3-class error; the serving fast path for throughput-bound
    consumers like particle advection)."""
    x = point_coords(pts_unit, t, cfg.norm)
    if precision == "f32":
        return mlp.forward(params, x)
    assert precision == "bf16", precision
    w1 = params["W1"].astype(jnp.bfloat16)
    w2 = params["W2"].astype(jnp.bfloat16)
    z1 = jnp.dot(
        x.astype(jnp.bfloat16), w1, preferred_element_type=jnp.float32
    ) + params["b1"]
    a1 = jnp.maximum(z1, 0.0)
    return jnp.dot(
        a1.astype(jnp.bfloat16), w2, preferred_element_type=jnp.float32
    ) + params["b2"]


def ngp_eval_points(ncfg, params: dict, pts_unit: jnp.ndarray, t) -> jnp.ndarray:
    """Encoded-field (NGP/Fourier/any registered family) evaluation at
    arbitrary unit-cube points: [..., out]. Thin alias of models.ngp.forward
    so both model families serve through one module."""
    from phys_autodiff_tpu.models import ngp as ngp_mod

    return ngp_mod.forward(ncfg, params, pts_unit, t)


def evaluate_points(model_cfg, params, pts_unit, t, precision="f32", **kw):
    """One dispatching entry point: model_cfg may be an MLPGridConfig or an
    NGPFieldConfig (any encoder family). Returns [..., 4] physics channels
    [sigma, ux, uy, uz] at the given unit-cube points and time.

    Contract: pts_unit must lie in [0, 1]^3 — the models' domain (hash
    encoders floor-index their lattices and would alias out of range).
    Callers working in periodic index space must fold the seam band first
    (see apps/advect.velocity_fn_from_model). precision="bf16" is served
    for the MLP family only (see mlp_eval_points)."""
    if isinstance(model_cfg, MLPGridConfig):
        return mlp_eval_points(model_cfg, params, pts_unit, t, precision)
    if precision != "f32":
        raise ValueError(
            "bf16 point serving is implemented for the coordinate MLP "
            "family only (encoded families keep their exact-f32 pointwise "
            "encoders)"
        )
    return ngp_eval_points(model_cfg, params, pts_unit, t, **kw)


def grid_infer_any(g: GridSpec, model_cfg, params, t) -> jnp.ndarray:
    """[nz, ny, nx, 4] raw model output on the full grid for EITHER model
    family — the grid-side analogue of evaluate_points' dispatch. The one
    place that routes MLPGridConfig vs encoded-family configs for grid
    inference (apps/transport, apps/euler, and models/solenoidal all go
    through here, so a new family plugs in once)."""
    if isinstance(model_cfg, MLPGridConfig):
        from phys_autodiff_tpu.models import fields as fields_mod

        return fields_mod.grid_infer(g, model_cfg, params, t)
    from phys_autodiff_tpu.models import ngp as ngp_mod

    return ngp_mod.grid_infer(g, model_cfg, params, t)


def evaluate_points_batched(
    model_cfg,
    params,
    pts_unit: jnp.ndarray,
    t,
    batch_size: int = 1 << 16,
    **kw,
):
    """evaluate_points over arbitrarily many points with bounded per-step
    memory: chunks of `batch_size` run under lax.map (one compiled body,
    sequential chunks), so P can exceed device-memory comfort.
    pts_unit: [P, 3]; returns [P, 4]."""
    p = pts_unit.shape[0]
    if p <= batch_size:
        return evaluate_points(model_cfg, params, pts_unit, t, **kw)
    n_chunks = -(-p // batch_size)
    pad = n_chunks * batch_size - p
    pts_pad = jnp.pad(pts_unit, ((0, pad), (0, 0)))
    chunks = pts_pad.reshape(n_chunks, batch_size, pts_unit.shape[-1])
    out = jax.lax.map(
        lambda c: evaluate_points(model_cfg, params, c, t, **kw), chunks
    )
    return out.reshape(n_chunks * batch_size, -1)[:p]


def _axis_corners(f: jnp.ndarray, n: int, periodic: bool):
    """Continuous index coordinate f -> (i0, i1, w1) on an n-node axis.

    periodic: f wraps with period n (node n IS node 0 — spacing h beyond
    the last node, matching the stencil's wrap topology, ops/stencil.py).
    clamp: f clips to [0, n-1] and the upper corner saturates — queries
    outside the box return the boundary value, the sampling analogue of the
    stencil's clampi (src/phys_cpu.cpp:8-15)."""
    if n <= 1:
        z = jnp.zeros_like(f, dtype=jnp.int32)
        return z, z, jnp.zeros_like(f)
    if periodic:
        f = jnp.mod(f, jnp.float32(n))
        i0 = jnp.floor(f).astype(jnp.int32)
        i0 = jnp.clip(i0, 0, n - 1)  # guard f == n after fp mod
        i1 = jnp.mod(i0 + 1, n)
    else:
        f = jnp.clip(f, 0.0, jnp.float32(n - 1))
        i0 = jnp.clip(jnp.floor(f).astype(jnp.int32), 0, n - 1)
        i1 = jnp.minimum(i0 + 1, n - 1)
    return i0, i1, f - i0.astype(jnp.float32)


def trilinear_sample(
    values: jnp.ndarray, pts_idx: jnp.ndarray, g: GridSpec
) -> jnp.ndarray:
    """Trilinear interpolation of grid values at continuous index coords.

    values: [..., nz, ny, nx] (any number of leading channel axes);
    pts_idx: [P, 3] continuous (x, y, z) grid-index coordinates;
    returns [P, ...channels] (channel axes moved last so a [3, nz, ny, nx]
    velocity field samples to [P, 3]).

    Boundary behavior follows g.periodic (wrap with period n / clamp),
    matching the stencil operators' topology. The 8 corner reads compile to
    flat one-axis gathers. Direct model evaluation (evaluate_points) is the
    alternative when a model exists; scripts/advect_bench.py times the two
    (on the H100 not measured yet). Use this for model-free grid data."""
    ch_shape = values.shape[:-3]
    nz, ny, nx = values.shape[-3:]
    assert (nz, ny, nx) == g.shape, (values.shape, g.shape)
    flat = values.reshape(ch_shape + (nz * ny * nx,))
    ix0, ix1, wx = _axis_corners(pts_idx[..., 0], nx, g.periodic)
    iy0, iy1, wy = _axis_corners(pts_idx[..., 1], ny, g.periodic)
    iz0, iz1, wz = _axis_corners(pts_idx[..., 2], nz, g.periodic)

    def corner(iz, iy, ix):
        # reference flat index order: idx = (z*ny + y)*nx + x; corners are
        # already wrapped/clamped in range, so promise it (skips the
        # out-of-bounds select in the lowered gather)
        lin = (iz * ny + iy) * nx + ix
        return flat.at[..., lin].get(mode="promise_in_bounds")  # [...ch, P]

    c000 = corner(iz0, iy0, ix0)
    c001 = corner(iz0, iy0, ix1)
    c010 = corner(iz0, iy1, ix0)
    c011 = corner(iz0, iy1, ix1)
    c100 = corner(iz1, iy0, ix0)
    c101 = corner(iz1, iy0, ix1)
    c110 = corner(iz1, iy1, ix0)
    c111 = corner(iz1, iy1, ix1)
    c00 = c000 + (c001 - c000) * wx
    c01 = c010 + (c011 - c010) * wx
    c10 = c100 + (c101 - c100) * wx
    c11 = c110 + (c111 - c110) * wx
    c0 = c00 + (c01 - c00) * wy
    c1 = c10 + (c11 - c10) * wy
    out = c0 + (c1 - c0) * wz  # [...ch, P]
    if ch_shape:
        out = jnp.moveaxis(out, -1, 0)  # [P, ...ch]
    return out
