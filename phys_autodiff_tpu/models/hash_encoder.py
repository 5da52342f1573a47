"""Multiresolution hash encoding (Instant-NGP style) — framework extension.

The reference has NO hash grid (SURVEY.md §0: its "mlp_grid" is a dense
coordinate MLP), but the project's north star frames it as an NGP-style
system, and the retrieved papers (PAPERS.md: Instant-NGP, hash-encoded
PINNs) point this way. This module adds the encoder as an extension on top
of the same field-generation API, so the physics loss can train either the
plain coordinate MLP or a hash-encoded field.

Technique (public, from the Instant-NGP paper): L resolution levels with
per-level feature tables of T entries x F features; a 3D coordinate is
scaled to the level resolution, its 8 surrounding corners are hashed into
the table (xor of per-dimension primes, mod T), and the gathered features
are trilinearly interpolated; level outputs concatenate into the encoding.

Notes:
  * Implemented as batched jnp gathers (jnp.take) over [T, F] tables —
    XLA lowers these to dynamic-gathers and the backward to scatter-adds.
  * Levels are stacked into one [L, T, F] parameter so a single gather per
    corner serves all levels.
  * Feature dim F is kept on the last axis.

DENSE LEVELS. The encoder BACKWARD of the hash form is a per-level
scatter-add of corner-lattice cotangents into the [T, F] tables — ~2.8M
rows at the default schedule, 2.15M of them from the r=128 level alone
(131x oversubscribed at T=2^14), a fixed tax at every grid size. With `dense_oversubscribed=True`, any level whose corner
lattice (r+1)^3 exceeds the table is stored DENSELY as a [r+1, r+1, r+1, F]
parameter grid: the parameters ARE the corner lattice, so the forward needs
no hash and no gather, and on a regular grid the trilinear interpolation
becomes three separable static resampling MATMULS whose backward is the
transposed matmul — no scatter at all, dense matmul work. (Instant-NGP itself
stores UNDER-subscribed levels densely; this is the same idea applied where
this workload actually hurts, accepting the larger parameter count —
~5.6M params vs 131K at the default schedule — in exchange for a
collision-free top level and a scatter-free backward.)

Parameter structure: all-hash configs keep the legacy [L, T, F] array;
configs with dense levels use a dict
    {"hash": [n_hash_levels, T, F], "dense": {"l<level>": [r+1,r+1,r+1,F]}}
— a structural change that checkpoint manifests detect on restore (see
train/checkpoint.py; `schedule_meta` provides a fingerprint to embed).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

# Per-dimension hashing primes from the Instant-NGP paper; dim 0 is left
# unmultiplied (prime 1) like the original.
_PRIMES = (1, 2654435761, 805459861)


@dataclasses.dataclass(frozen=True)
class HashEncodingConfig:
    num_levels: int = 8  # L
    features_per_level: int = 2  # F
    log2_table_size: int = 14  # T = 2^14 entries per level
    base_resolution: int = 4  # N_min
    max_resolution: int = 128  # N_max (sets the growth factor)
    # Store oversubscribed levels ((r+1)^3 > T) as dense corner-lattice
    # parameter grids instead of hashed tables (see module docstring).
    dense_oversubscribed: bool = False

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    @property
    def out_dim(self) -> int:
        return self.num_levels * self.features_per_level

    def level_is_dense(self, level: int) -> bool:
        if not self.dense_oversubscribed:
            return False
        r = int(self.level_resolutions()[level])
        return (r + 1) ** 3 > self.table_size

    def dense_levels(self) -> list:
        return [l for l in range(self.num_levels) if self.level_is_dense(l)]

    def hash_levels(self) -> list:
        return [l for l in range(self.num_levels) if not self.level_is_dense(l)]

    def level_resolutions(self) -> np.ndarray:
        """Geometric schedule N_l = round(N_min * b^l). Rounded (not
        floored): fp rounding makes b^(L-1) land a hair under its exact
        value, and flooring that would top the schedule out at
        N_max - 1 — the configured max_resolution must be reachable."""
        if self.num_levels == 1:
            return np.asarray([self.base_resolution])
        ln = np.linspace(
            np.log(self.base_resolution),
            np.log(self.max_resolution),
            self.num_levels,
        )
        return np.floor(np.exp(ln) + 0.5).astype(np.int64)


def init_hash_params(cfg: HashEncodingConfig, seed: int = 0, scale: float = 1e-4):
    """Uniform(-scale, scale) init (the paper's initialization).

    All-hash configs return the legacy [L, T, F] array; configs with dense
    levels return {"hash": [n_hash, T, F], "dense": {"l<level>": grid}} (see
    module docstring)."""
    rng = np.random.Generator(np.random.MT19937(seed))
    dense_lvls = cfg.dense_levels()
    hash_arr = rng.uniform(
        -scale,
        scale,
        size=(cfg.num_levels - len(dense_lvls), cfg.table_size, cfg.features_per_level),
    ).astype(np.float32)
    if not dense_lvls:
        return jnp.asarray(hash_arr)
    res = cfg.level_resolutions()
    dense = {
        f"l{l}": jnp.asarray(
            rng.uniform(
                -scale,
                scale,
                size=(int(res[l]) + 1,) * 3 + (cfg.features_per_level,),
            ).astype(np.float32)
        )
        for l in dense_lvls
    }
    return {"hash": jnp.asarray(hash_arr), "dense": dense}


def schedule_meta(cfg: HashEncodingConfig) -> dict:
    """JSON-safe fingerprint of the encoding schedule, for embedding in
    checkpoints: the level resolutions once changed from floor to round, and
    the dense levels change the parameter tree — restoring old tables into
    a new-schedule config decodes to different fields silently unless this
    is checked."""
    return {
        "resolutions": [int(r) for r in cfg.level_resolutions()],
        "dense_levels": cfg.dense_levels(),
        "table_size": cfg.table_size,
        "features_per_level": cfg.features_per_level,
    }


def _tables_view(cfg: HashEncodingConfig, tables):
    """(hash_tables [n_hash, T, F], {level: dense grid}) from either the
    legacy all-hash array or the dict structure."""
    if isinstance(tables, dict):
        dense = {int(k[1:]): v for k, v in tables["dense"].items()}
        return tables["hash"], dense
    if cfg.dense_levels():
        raise TypeError(
            "config has dense levels but `tables` is a plain array — "
            "initialize with init_hash_params(cfg) to get the dict structure"
        )
    return tables, {}


def _hash_corner(ix, iy, iz, table_size: int):
    """Spatial hash of integer corner coords -> table index. uint32 xor of
    per-dimension primes, mod table size (a power of two)."""
    h = (
        ix.astype(jnp.uint32) * np.uint32(_PRIMES[0])
        ^ iy.astype(jnp.uint32) * np.uint32(_PRIMES[1])
        ^ iz.astype(jnp.uint32) * np.uint32(_PRIMES[2])
    )
    return (h & np.uint32(table_size - 1)).astype(jnp.int32)


def encode(cfg: HashEncodingConfig, tables, coords: jnp.ndarray):
    """Encode 3D coordinates in [0, 1] (8 gathers per point and level).

    tables: [L, T, F] (all-hash) or the dense-level dict (module docstring);
    coords: [..., 3] -> [..., L*F]. Differentiable in `tables` (and in
    `coords` through the interpolation weights). On a regular grid,
    `encode_grid` serves the same values with static indices.
    """
    batch_shape = coords.shape[:-1]
    x = coords.reshape(-1, 3)  # [N, 3]
    res_all = cfg.level_resolutions()
    hash_tables, dense = _tables_view(cfg, tables)
    hash_lvls = cfg.hash_levels()

    per_level = [None] * cfg.num_levels
    if hash_lvls:
        res = jnp.asarray(res_all[hash_lvls], jnp.float32)  # [Lh]
        # Scaled coordinates per hashed level: [Lh, N, 3]
        xs = x[None, :, :] * (res[:, None, None] - 1.0)
        x0 = jnp.floor(xs)
        frac = xs - x0  # [Lh, N, 3]
        x0 = x0.astype(jnp.int32)

        feats = []
        for corner in range(8):
            dx, dy, dz = corner & 1, (corner >> 1) & 1, (corner >> 2) & 1
            cx = x0[..., 0] + dx
            cy = x0[..., 1] + dy
            cz = x0[..., 2] + dz
            idx = _hash_corner(cx, cy, cz, cfg.table_size)  # [Lh, N]
            # gather per level: tables [Lh, T, F] indexed along T
            f = jnp.take_along_axis(
                hash_tables, idx[:, :, None].astype(jnp.int32), axis=1
            )  # [Lh, N, F]
            wx = jnp.where(dx == 1, frac[..., 0], 1.0 - frac[..., 0])
            wy = jnp.where(dy == 1, frac[..., 1], 1.0 - frac[..., 1])
            wz = jnp.where(dz == 1, frac[..., 2], 1.0 - frac[..., 2])
            feats.append(f * (wx * wy * wz)[:, :, None])
        hash_out = sum(feats)  # [Lh, N, F]
        for i, l in enumerate(hash_lvls):
            per_level[l] = hash_out[i]
    for l, grid in dense.items():
        per_level[l] = _encode_dense_pointwise(grid, int(res_all[l]), x)

    out = jnp.concatenate(per_level, axis=-1)  # [N, L*F]
    return out.reshape(*batch_shape, cfg.out_dim)


def _encode_dense_pointwise(grid: jnp.ndarray, r: int, x: jnp.ndarray):
    """Trilinear interpolation of a dense [r+1, r+1, r+1, F] corner lattice
    at points x [N, 3] in [0,1] — same math as a hashed level, with the
    lattice index replacing the spatial hash. -> [N, F]"""
    flat = grid.reshape(-1, grid.shape[-1])
    xs = x * jnp.float32(r - 1)
    x0 = jnp.floor(xs)
    frac = xs - x0  # [N, 3]
    x0 = x0.astype(jnp.int32)
    out = jnp.zeros((x.shape[0], grid.shape[-1]), grid.dtype)
    for corner in range(8):
        dx, dy, dz = corner & 1, (corner >> 1) & 1, (corner >> 2) & 1
        idx = (
            (x0[:, 2] + dz) * (r + 1) + (x0[:, 1] + dy)
        ) * (r + 1) + (x0[:, 0] + dx)
        f = jnp.take(flat, idx, axis=0)  # [N, F]
        wx = jnp.where(dx == 1, frac[:, 0], 1.0 - frac[:, 0])
        wy = jnp.where(dy == 1, frac[:, 1], 1.0 - frac[:, 1])
        wz = jnp.where(dz == 1, frac[:, 2], 1.0 - frac[:, 2])
        out = out + f * (wx * wy * wz)[:, None]
    return out


def _axis_lerp(grid, n: int, r: int, axis: int):
    """Linearly resample `grid` from r+1 samples to n samples along `axis`
    using STATIC (numpy, trace-time) indices and weights — the regular-grid
    target positions v/(n-1)*(r-1) are known at trace time, so this lowers
    to two constant-index gathers + one FMA instead of per-point dynamic
    gathers."""
    if n == 1:
        idx0 = np.zeros((1,), np.int32)
        w = np.zeros((1,), np.float32)
    else:
        pos = np.arange(n, dtype=np.float64) / (n - 1) * (r - 1)
        idx0 = np.floor(pos).astype(np.int32)
        w = (pos - idx0).astype(np.float32)
    lo = jnp.take(grid, jnp.asarray(idx0), axis=axis)
    hi = jnp.take(grid, jnp.asarray(idx0 + 1), axis=axis)
    shape = [1] * grid.ndim
    shape[axis] = n
    wv = jnp.asarray(w).reshape(shape)
    return lo * (1.0 - wv) + hi * wv


def _resample_matrix(n: int, r: int) -> np.ndarray:
    """Static [r+1, n] linear-interpolation matrix taking r+1 corner samples
    to n grid samples at positions v/(n-1)*(r-1) — two nonzeros per column
    (1-w at idx0, w at idx0+1), built in float64 at trace time like
    _axis_lerp's weights. n == 1 degenerates to selecting sample 0."""
    m = np.zeros((r + 1, n), np.float32)
    if n == 1:
        m[0, 0] = 1.0
        return m
    pos = np.arange(n, dtype=np.float64) / (n - 1) * (r - 1)
    i0 = np.floor(pos).astype(np.int64)
    w = pos - i0
    cols = np.arange(n)
    m[i0, cols] += (1.0 - w).astype(np.float32)
    m[i0 + 1, cols] += w.astype(np.float32)
    return m


def _axis_lerp_dense(grid, n: int, r: int, axis: int):
    """Matmul form of _axis_lerp: contracting with the static interpolation
    matrix makes the VJP a TRANSPOSED MATMUL instead of a scatter-add — the
    whole point of dense levels (the backward scatter into the tables was
    the NGP step's bottleneck). HIGHEST precision keeps the two-nonzero
    contraction bit-comparable to the lerp's f32 FMA (no TF32)."""
    m = jnp.asarray(_resample_matrix(n, r))
    out = jnp.tensordot(grid, m, axes=([axis], [0]),
                        precision=jax.lax.Precision.HIGHEST)
    # tensordot appends the new axis last; restore it to `axis`
    return jnp.moveaxis(out, -1, axis)


def encode_grid(cfg: HashEncodingConfig, tables, g) -> jnp.ndarray:
    """Hash-encode every point of a REGULAR grid (GridSpec g, coords
    v/(n-1) in [0,1] per axis) -> [nz, ny, nx, L*F].

    Mathematically the same trilinear hash encoding as `encode` on the
    grid's coordinates, restructured for regular grids: per level, the (R_l+1)^3
    corner-feature grid is gathered ONCE with hash indices precomputed in
    numpy at trace time (a single constant-index gather instead of 8
    dynamic gathers per cell x level — ~75M of them at 128x96x96), then
    trilinear interpolation factorizes into three separable static-index
    axis resamples (dense elementwise FMAs). Equal to `encode` up to interpolation-
    weight precision: the static weights here are computed in float64,
    while `encode` derives them from f32 scaled coordinates, so the two
    drift by ~R*eps_f32 per level (~1e-5 absolute at R=128) — with THIS
    path the more accurate one.

    Dense levels skip the gather entirely: their parameters ARE the corner
    lattice, and all three resamples run as static matmuls whose backward is
    the transposed matmul (no scatter — see _axis_lerp_dense).
    """
    nz, ny, nx = g.shape
    hash_tables, dense = _tables_view(cfg, tables)
    hash_pos = {l: i for i, l in enumerate(cfg.hash_levels())}
    outs = []
    for lvl, r in enumerate(cfg.level_resolutions()):
        r = int(r)
        if lvl in dense:
            corner = dense[lvl]  # [r+1, r+1, r+1, F] — the parameters
            lev = _axis_lerp_dense(corner, nz, r, 0)
            lev = _axis_lerp_dense(lev, ny, r, 1)
            lev = _axis_lerp_dense(lev, nx, r, 2)
            outs.append(lev)
            continue
        # static corner hash indices for the full (r+1)^3 corner lattice
        # (index r is reachable with weight 0 at the top edge; hashing it
        # mirrors `encode`'s out-of-range corner behavior)
        ii = np.arange(r + 1, dtype=np.uint32)
        hx = ii * np.uint32(_PRIMES[0])
        hy = ii * np.uint32(_PRIMES[1])
        hz = ii * np.uint32(_PRIMES[2])
        h = hz[:, None, None] ^ hy[None, :, None] ^ hx[None, None, :]
        idx = (h & np.uint32(cfg.table_size - 1)).astype(np.int32)  # [z,y,x]
        corner = jnp.take(hash_tables[hash_pos[lvl]], jnp.asarray(idx.ravel()), axis=0)
        corner = corner.reshape(r + 1, r + 1, r + 1, cfg.features_per_level)
        lev = _axis_lerp(corner, nz, r, 0)
        lev = _axis_lerp(lev, ny, r, 1)
        lev = _axis_lerp(lev, nx, r, 2)
        outs.append(lev)
    return jnp.concatenate(outs, axis=-1)
