"""NGP-style field model: multiresolution hash encoding + small MLP head.

Extension beyond the reference (which only has the dense coordinate MLP —
SURVEY.md §0): the hash-encoded field maps (x, y, z) through the
multiresolution hash tables, concatenates normalized time, and decodes with
a small MLP into the four physics channels [sigma, ux, uy, uz]. It plugs
into the same FieldSnapshots / physics-loss pipeline and is trainable end to
end through jax.grad (tables and head together).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from phys_autodiff_tpu.models import encoders
from phys_autodiff_tpu.models.hash_encoder import HashEncodingConfig
from phys_autodiff_tpu.ops.stencil import FieldSnapshots
from phys_autodiff_tpu.utils.config import GridSpec


@dataclasses.dataclass(frozen=True)
class NGPFieldConfig:
    # Any models.encoders family: HashEncodingConfig (default) or
    # FourierEncodingConfig — the head, kernels, and training step are
    # encoder-agnostic. The default hash encoding stores oversubscribed
    # levels densely: the hashed top levels' backward scatter-add (~2.8M
    # corner rows into 16K-row tables) dominated the train step at every
    # grid size; dense levels make it a transposed matmul (hash_encoder
    # module docstring). Pass an explicit
    # HashEncodingConfig(dense_oversubscribed=False) for the pure
    # hash-table variant.
    encoding: object = dataclasses.field(
        default_factory=lambda: HashEncodingConfig(dense_oversubscribed=True)
    )
    hidden: int = 64
    out: int = 4  # [sigma, ux, uy, uz]

    @property
    def head_in(self) -> int:
        return self.encoding.out_dim + 1  # + normalized time channel


def init_ngp_params(cfg: NGPFieldConfig, seed: int = 0) -> dict:
    rng = np.random.Generator(np.random.MT19937(seed + 1))
    lim1 = float(np.sqrt(6.0 / (cfg.head_in + cfg.hidden)))
    lim2 = float(np.sqrt(6.0 / (cfg.hidden + cfg.out)))
    return {
        "tables": encoders.init_params(cfg.encoding, seed=seed),
        "W1": jnp.asarray(
            rng.uniform(-lim1, lim1, (cfg.head_in, cfg.hidden)).astype(np.float32)
        ),
        "b1": jnp.zeros((cfg.hidden,), jnp.float32),
        "W2": jnp.asarray(
            rng.uniform(-lim2, lim2, (cfg.hidden, cfg.out)).astype(np.float32)
        ),
        "b2": jnp.zeros((cfg.out,), jnp.float32),
    }


def _apply_head(params: dict, enc: jnp.ndarray, t):
    """The 2-layer decode head on a precomputed encoding — the ONE place
    its semantics live (time channel concat, relu, f32-accumulated dots)."""
    t_chan = jnp.broadcast_to(jnp.float32(t), enc.shape[:-1] + (1,))
    h = jnp.concatenate([enc, t_chan], axis=-1)
    # HIGHEST: the DEFAULT matmul precision may run f32 dots as TF32 on a
    # GPU (about three decimal digits), which would silently demote this f32
    # reference path. Same doctrine as the coordinate MLP's pinned matmuls.
    a1 = jnp.maximum(
        jnp.dot(h, params["W1"], preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)
        + params["b1"],
        0.0,
    )
    return (
        jnp.dot(a1, params["W2"], preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)
        + params["b2"]
    )


def _head_base(params: dict, enc: jnp.ndarray, precision: str = "f32"):
    """enc @ W1[:-1] + b1 — the time-independent part of layer 1. Time is
    the LAST input channel (see _apply_head's concat), so it enters layer 1
    only as the rank-1 term t * W1[-1]: one [N, L*F] x [L*F, H] matmul
    serves all three time slices (the NGP analogue of the coordinate MLP's
    rank-1 layer-1 folding).

    precision="bf16": bf16 matmul operands with f32 accumulation — the
    mixed tier (same doctrine as the coordinate MLP's bf16 field generator;
    the encoder stays exact f32)."""
    w1 = params["W1"][:-1]
    if precision == "bf16":
        enc, w1 = enc.astype(jnp.bfloat16), w1.astype(jnp.bfloat16)
    prec = (
        jax.lax.Precision.DEFAULT
        if precision == "bf16"
        else jax.lax.Precision.HIGHEST  # f32 tier: no TF32
    )
    return (
        jnp.dot(enc, w1, preferred_element_type=jnp.float32, precision=prec)
        + params["b1"]
    )


def _head_from_base(params: dict, base: jnp.ndarray, t, precision: str = "f32"):
    """Finish the decode head from the shared layer-1 base at time t.
    Mathematically equal to _apply_head up to one f32 reassociation (the
    concat dot reduces 17 terms in one chain; here 16 + 1)."""
    z1 = base + jnp.float32(t) * params["W1"][-1]
    a1 = jnp.maximum(z1, 0.0)
    w2 = params["W2"]
    if precision == "bf16":
        a1, w2 = a1.astype(jnp.bfloat16), w2.astype(jnp.bfloat16)
    prec = (
        jax.lax.Precision.DEFAULT
        if precision == "bf16"
        else jax.lax.Precision.HIGHEST
    )
    return (
        jnp.dot(a1, w2, preferred_element_type=jnp.float32, precision=prec)
        + params["b2"]
    )


def forward(cfg: NGPFieldConfig, params: dict, coords: jnp.ndarray, t):
    """coords: [..., 3] spatial in [0, 1]; t: scalar. Returns [..., out].

    Pointwise path; grid_infer / generate_fields serve regular grids."""
    enc = encoders.encode(cfg.encoding, params["tables"], coords)
    return _apply_head(params, enc, t)


def checkpoint_meta(cfg: NGPFieldConfig) -> dict:
    """Metadata to embed when checkpointing NGP params (see
    train.checkpoint.save_npz(meta=...)): detects encoding-schedule or
    dense-level mismatches on restore instead of decoding silently-different
    fields."""
    return {"ngp_encoding": encoders.schedule_meta(cfg.encoding)}


def _unit_coords(g: GridSpec) -> jnp.ndarray:
    """Spatial grid coordinates in [0, 1], [nz, ny, nx, 3] — the shared
    per-axis v/(n-1) logic of coords._axis_coord (incl. the degenerate-axis
    zero), stacked without the MLP path's time channel."""
    from phys_autodiff_tpu.models.coords import _axis_coord
    from phys_autodiff_tpu.utils.config import CoordNorm

    cx = _axis_coord(g.nx, CoordNorm.ZeroToOne)
    cy = _axis_coord(g.ny, CoordNorm.ZeroToOne)
    cz = _axis_coord(g.nz, CoordNorm.ZeroToOne)
    shape = g.shape
    return jnp.stack(
        [
            jnp.broadcast_to(cx[None, None, :], shape),
            jnp.broadcast_to(cy[None, :, None], shape),
            jnp.broadcast_to(cz[:, None, None], shape),
        ],
        axis=-1,
    )


def grid_infer(g: GridSpec, cfg: NGPFieldConfig, params: dict, t):
    """[nz, ny, nx, out] — hash-encoded analogue of models.fields.grid_infer.

    Uses the regular-grid encoder (per-level static-index corner gather +
    separable resampling, hash_encoder.encode_grid) instead of per-cell
    dynamic gathers; Fourier encodings broadcast per-axis features."""
    enc = encoders.encode_grid(cfg.encoding, params["tables"], g)
    return _apply_head(params, enc, t)


def generate_fields(
    g: GridSpec, cfg: NGPFieldConfig, params: dict, t, dt,
    precision: str = "f32",
) -> FieldSnapshots:
    """Fields at t-dt, t, t+dt; the hash encoding is shared across the three
    slices (time enters only through the head), so it is computed once —
    with the regular-grid encoder (static-index corner gathers + separable
    resampling; see hash_encoder.encode_grid). precision="bf16" runs the
    decode-head matmuls with bf16 operands (f32 accumulation, exact-f32
    encoder) — the mixed tier."""
    enc = encoders.encode_grid(cfg.encoding, params["tables"], g)
    base = _head_base(params, enc, precision)  # shared layer-1 matmul (1x)

    def head(tt):
        return _head_from_base(params, base, tt, precision)

    ys = [head(jnp.float32(t) - jnp.float32(dt)), head(t), head(jnp.float32(t) + jnp.float32(dt))]
    sigmas = [y[..., 0] for y in ys]
    us = [jnp.moveaxis(y[..., 1:4], -1, -4) for y in ys]
    return FieldSnapshots(
        sigma_tm1=sigmas[0],
        sigma_t=sigmas[1],
        sigma_tp1=sigmas[2],
        u_tm1=us[0],
        u_t=us[1],
        u_tp1=us[2],
    )
