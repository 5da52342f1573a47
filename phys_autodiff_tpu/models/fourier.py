"""Axis-separable Fourier-feature (positional) encoding — framework extension.

The reference has only the dense coordinate MLP (SURVEY.md §0); the NGP
extension added the multiresolution hash encoding. This module adds the
third classic PINN/NeRF field parameterization: per-axis sinusoidal
positional features

    gamma(v) = [v?, sin(pi 2^0 v), cos(pi 2^0 v), ..., sin(pi 2^{K-1} v),
                cos(pi 2^{K-1} v)]   per axis, concatenated over (x, y, z),

which counters the spectral bias of plain coordinate MLPs (retrieved
PAPERS.md: Fourier-feature networks / NeRF positional encoding). It plugs
into the SAME encoded-field machinery as the hash encoding — the generic
`models.encoders` dispatch feeds `ngp.NGPFieldConfig(encoding=...)`, the
decode head, the training step and the sharded step — because everything
downstream only consumes an [..., out_dim] encoding.

Notes:
  * The encoding has NO parameters (`init_params` returns an empty f32
    array so the params pytree keeps the uniform {"tables", W1, ...}
    shape; its cotangent is an empty array).
  * On a REGULAR grid every channel is a function of ONE axis coordinate:
    `encode_grid` builds three tiny per-axis feature matrices ([n, C] with
    C = include_input + 2K) and broadcasts — no grid-sized transcendentals,
    bit-identical to the pointwise path on the same f32 coordinates.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class FourierEncodingConfig:
    """NeRF-style axis-aligned positional encoding over [0, 1] coordinates.

    num_frequencies: octaves per axis (frequencies pi * 2^k, k < K).
    include_input: prepend the raw coordinate channel per axis (the NeRF
    default), so the encoding strictly extends the identity features the
    plain coordinate MLP sees.
    """

    num_frequencies: int = 6
    include_input: bool = True

    @property
    def axis_dim(self) -> int:
        return (1 if self.include_input else 0) + 2 * self.num_frequencies

    @property
    def out_dim(self) -> int:
        return 3 * self.axis_dim


def init_params(cfg: FourierEncodingConfig, seed: int = 0):
    """The encoding is analytic — no parameters. An empty f32 array keeps
    the encoded-field params pytree uniform across encoder families (the
    optimizer, checkpointing, and every `params["tables"]` access all see
    the same structure)."""
    del seed
    return jnp.zeros((0,), jnp.float32)


def schedule_meta(cfg: FourierEncodingConfig) -> dict:
    """Checkpoint fingerprint (see hash_encoder.schedule_meta): restoring
    under a different frequency schedule decodes different fields, and a
    Fourier meta never equals a hash meta (disjoint keys)."""
    return {
        "fourier_num_frequencies": cfg.num_frequencies,
        "fourier_include_input": cfg.include_input,
    }


def _axis_features(cfg: FourierEncodingConfig, v: jnp.ndarray) -> jnp.ndarray:
    """Per-axis feature stack: v [...] -> [..., axis_dim]. The frequencies
    are trace-time f32 constants; sin/cos run on the same f32 coordinate
    values everywhere (pointwise == grid, bit-identical)."""
    v = v.astype(jnp.float32)
    feats = []
    if cfg.include_input:
        feats.append(v)
    for k in range(cfg.num_frequencies):
        w = np.float32(np.pi * (2.0**k))
        feats.append(jnp.sin(w * v))
        feats.append(jnp.cos(w * v))
    return jnp.stack(feats, axis=-1)


def encode(cfg: FourierEncodingConfig, coords: jnp.ndarray) -> jnp.ndarray:
    """coords [..., 3] (x, y, z in [0, 1]) -> [..., out_dim], channels in
    axis-major order [x-features | y-features | z-features] (the same
    coordinate convention as hash_encoder.encode / ngp._unit_coords).
    Pointwise and safe at any batch size — there are no gathers."""
    return jnp.concatenate(
        [_axis_features(cfg, coords[..., a]) for a in range(3)], axis=-1
    )


def _axis_vectors(cfg: FourierEncodingConfig, g):
    """The three per-axis feature matrices ([nx, C], [ny, C], [nz, C]) on
    the regular grid's v/(n-1) coordinates (degenerate axes -> coord 0,
    models.coords._axis_coord)."""
    from phys_autodiff_tpu.models.coords import _axis_coord
    from phys_autodiff_tpu.utils.config import CoordNorm

    fx = _axis_features(cfg, _axis_coord(g.nx, CoordNorm.ZeroToOne))
    fy = _axis_features(cfg, _axis_coord(g.ny, CoordNorm.ZeroToOne))
    fz = _axis_features(cfg, _axis_coord(g.nz, CoordNorm.ZeroToOne))
    return fx, fy, fz


def encode_grid(cfg: FourierEncodingConfig, g) -> jnp.ndarray:
    """Encode every point of a regular grid -> [nz, ny, nx, out_dim].

    Each channel depends on one axis only, so this is three [n, C]
    transcendental evaluations plus broadcasts — bit-identical to
    encode(unit_coords) (same f32 inputs to the same sin/cos)."""
    nz, ny, nx = g.shape
    fx, fy, fz = _axis_vectors(cfg, g)
    c = cfg.axis_dim
    return jnp.concatenate(
        [
            jnp.broadcast_to(fx[None, None, :, :], (nz, ny, nx, c)),
            jnp.broadcast_to(fy[None, :, None, :], (nz, ny, nx, c)),
            jnp.broadcast_to(fz[:, None, None, :], (nz, ny, nx, c)),
        ],
        axis=-1,
    )
