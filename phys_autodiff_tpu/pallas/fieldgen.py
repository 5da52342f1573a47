"""Coordinate-MLP field generation as one Pallas (Triton) kernel pair.

`jax.value_and_grad` of the plain pipeline (models/fields.py) keeps the
[3N, H] hidden activation for the backward: at 128x96x96 with H=128 that is
1.81 GB written once and read at least twice. This pair recomputes it
instead, the way the reference's fused CUDA backward recomputes its forward
stencil: the forward writes only the 12 field channels, the backward reads
only their cotangent, and nothing of size [N, H] ever reaches device memory.
XLA keeps the stencil, the loss and their adjoint (ops/).

Both kernels walk power-of-two tiles of flat cell indices
(idx = (z*ny + y)*nx + x, the reference's layout) with a masked tail, so
no grid needs padding:

* forward: (i, j, k) from the flat index, the axis coordinates gathered
  from models/coords.py's own tables, layer 1 as four broadcast FMAs
  (K=4 is not a dot) summed per cell in the plain generator's order,
  x, y, z, t, then the bias, so no rounding is shared by a whole time
  slice (a shared one shifts every cell's time difference alike, and the
  1/(2 dt) of the residual turns it into a loss bias), ReLU, layer 2 as
  `pl.dot` against W2 zero-padded to 16 columns (Triton's smallest dot
  width), written straight into a [12, N] block whose rows are (slice,
  channel) — the FieldSnapshots layout ops/ reads, no relayout.
* backward: the same tiling; it recomputes z1 per slice and forms per-
  program partials of dW2 = a1^T gy, db2, and [dW1_xyz; dz1 per slice] =
  basis^T dz1 with dz1 = (gy W2^T) * [z1 > 0]. XLA sums the partials in a
  fixed order (no atomics: reductions stay deterministic) and forms W1's t
  row, b1 and the time values' gradients from the per-slice sums.

The kernel's inputs are tensors (axis tables, W1 and b1 zero-padded to a
power-of-two width, the three time values broadcast along it, padded
W2/b2); `generate_fields` builds them from the params with plain JAX, so
autodiff carries the gradient on to t.

Precision: "f32" runs every dot at HIGHEST (IEEE f32, no TF32); "bf16"
feeds the layer-2 dots bf16 operands with f32 accumulation and keeps the
coordinate dot of dW1 in f32.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from phys_autodiff_tpu.backend import pallas_interpret
from phys_autodiff_tpu.models.coords import _axis_coord
from phys_autodiff_tpu.ops.stencil import FieldSnapshots
from phys_autodiff_tpu.utils.config import CoordNorm, GridSpec, MLPGridConfig

_PAD = 16  # Triton's smallest dot width: W2's 4 columns are padded to it
# (cells per tile, warps per program) for each precision, from a sweep of
# the full train step on an H100 at 128x96x96, H=128 (PERF.md): 32 cells
# and 8 warps is fastest in both tiers; 64 or more cells per tile, or fewer
# warps, spill registers and run 2-12 times slower.
_TILING = {"f32": (32, 8), "bf16": (32, 8)}
_MAX_PROGRAMS = 1024  # backward partials: at most this many [16, Hp] blocks

_HIGHEST = jax.lax.Precision.HIGHEST


def _hidden_pad(h: int) -> int:
    return max(_PAD, 1 << (h - 1).bit_length())


def _tile(cx_ref, cy_ref, cz_ref, offs, nx, ny, n):
    """Axis coordinates of the cells at flat indices `offs` (masked tail)."""
    mask = offs < n
    i = offs % nx
    j = (offs // nx) % ny
    k = offs // (nx * ny)
    cx = plt.load(cx_ref.at[i], mask=mask, other=0.0)
    cy = plt.load(cy_ref.at[j], mask=mask, other=0.0)
    cz = plt.load(cz_ref.at[k], mask=mask, other=0.0)
    return mask, cx, cy, cz


def _weights(w1_ref, tv_ref, b1_ref, hp):
    hidx = jnp.arange(hp)
    w1 = [plt.load(w1_ref.at[r, hidx]) for r in range(4)]
    tv = [plt.load(tv_ref.at[s, hidx]) for s in range(3)]
    return w1, tv, plt.load(b1_ref.at[hidx])


def _z1(cx, cy, cz, w1, tv_s, b1):
    return (
        cx[:, None] * w1[0][None, :]
        + cy[:, None] * w1[1][None, :]
        + cz[:, None] * w1[2][None, :]
        + tv_s[None, :] * w1[3][None, :]
        + b1[None, :]
    )


def _fwd_kernel(cx_ref, cy_ref, cz_ref, w1_ref, tv_ref, b1_ref, w2_ref,
                b2_ref, out_ref, *, nx, ny, n, hp, block, dot_dtype):
    offs = pl.program_id(0) * block + jnp.arange(block)
    mask, cx, cy, cz = _tile(cx_ref, cy_ref, cz_ref, offs, nx, ny, n)
    w1, tv, b1 = _weights(w1_ref, tv_ref, b1_ref, hp)
    w2 = w2_ref[...].astype(dot_dtype)
    b2 = b2_ref[...]
    col = jnp.arange(_PAD)[None, :]
    for s in range(3):
        a1 = jnp.maximum(_z1(cx, cy, cz, w1, tv[s], b1), 0.0)
        y = pl.dot(a1.astype(dot_dtype), w2, precision=_HIGHEST) + b2[None, :]
        for c in range(4):
            yc = jnp.sum(jnp.where(col == c, y, 0.0), axis=1)
            plt.store(out_ref.at[4 * s + c, offs], yc, mask=mask)


def _bwd_kernel(cx_ref, cy_ref, cz_ref, w1_ref, tv_ref, b1_ref, w2_ref,
                ct_ref, dw1_ref, dw2_ref, db2_ref, *, nx, ny, n, hp, block,
                tiles, dot_dtype):
    pid = pl.program_id(0)
    w1, tv, b1 = _weights(w1_ref, tv_ref, b1_ref, hp)
    w2 = w2_ref[...].astype(dot_dtype)
    col = jnp.arange(_PAD)[None, :]

    def body(it, acc):
        offs = (pid * tiles + it) * block + jnp.arange(block)
        mask, cx, cy, cz = _tile(cx_ref, cy_ref, cz_ref, offs, nx, ny, n)
        for s in range(3):
            z1 = _z1(cx, cy, cz, w1, tv[s], b1)
            a1 = jnp.maximum(z1, 0.0)
            gy = jnp.zeros((block, _PAD), jnp.float32)
            for c in range(4):
                gc = plt.load(ct_ref.at[4 * s + c, offs], mask=mask, other=0.0)
                gy = gy + jnp.where(col == c, gc[:, None], 0.0)
            gyd = gy.astype(dot_dtype)
            da1 = pl.dot(gyd, w2, trans_b=True, precision=_HIGHEST)
            dz1 = jnp.where(z1 > 0.0, da1, 0.0)
            # basis columns: x, y, z coordinate, then a one in column 3+s,
            # so rows 3..5 of basis^T dz1 are the per-slice sums of dz1
            basis = (
                jnp.where(col == 0, cx[:, None], 0.0)
                + jnp.where(col == 1, cy[:, None], 0.0)
                + jnp.where(col == 2, cz[:, None], 0.0)
                + jnp.where((col == 3 + s) & mask[:, None], 1.0, 0.0)
            )
            terms = (
                pl.dot(basis, dz1, trans_a=True, precision=_HIGHEST),
                pl.dot(a1.astype(dot_dtype), gyd, trans_a=True,
                       precision=_HIGHEST),
                jnp.sum(gy, axis=0),
            )
            acc = tuple(a + x for a, x in zip(acc, terms))
        return acc

    acc0 = (
        jnp.zeros((_PAD, hp), jnp.float32),
        jnp.zeros((hp, _PAD), jnp.float32),
        jnp.zeros((_PAD,), jnp.float32),
    )
    acc1, acc2, accb = jax.lax.fori_loop(0, tiles, body, acc0)
    dw1_ref[...] = acc1
    dw2_ref[...] = acc2
    db2_ref[...] = accb


def _launch_plan(n: int, block: int):
    """(tiles per program, programs) for the backward."""
    tiles = pl.cdiv(pl.cdiv(n, block), _MAX_PROGRAMS)
    return tiles, pl.cdiv(pl.cdiv(n, block), tiles)


def _dot_dtype(precision: str):
    return {"f32": jnp.float32, "bf16": jnp.bfloat16}[precision]


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def _fieldgen(shape, precision, interpret, tables, w1, tv, b1, w2p, b2p):
    return _fieldgen_fwd(shape, precision, interpret, tables, w1, tv, b1,
                         w2p, b2p)[0]


def _fieldgen_fwd(shape, precision, interpret, tables, w1, tv, b1, w2p, b2p):
    r, ny, nx = shape
    n = r * ny * nx
    hp = w2p.shape[0]
    block, num_warps = _TILING[precision]
    kernel = functools.partial(
        _fwd_kernel, nx=nx, ny=ny, n=n, hp=hp, block=block,
        dot_dtype=_dot_dtype(precision),
    )
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((12, n), jnp.float32),
        grid=(pl.cdiv(n, block),),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps,
                                           num_stages=1),
        interpret=interpret,
        name="fieldgen_fwd",
    )(*tables, w1, tv, b1, w2p, b2p)
    return out, (tables, w1, tv, b1, w2p)


def _fieldgen_bwd(shape, precision, interpret, res, ct):
    tables, w1, tv, b1, w2p = res
    r, ny, nx = shape
    n = r * ny * nx
    hp = w2p.shape[0]
    block, num_warps = _TILING[precision]
    tiles, programs = _launch_plan(n, block)
    kernel = functools.partial(
        _bwd_kernel, nx=nx, ny=ny, n=n, hp=hp, block=block, tiles=tiles,
        dot_dtype=_dot_dtype(precision),
    )
    dw1p, dw2p, db2p = pl.pallas_call(
        kernel,
        out_shape=(
            jax.ShapeDtypeStruct((programs, _PAD, hp), jnp.float32),
            jax.ShapeDtypeStruct((programs, hp, _PAD), jnp.float32),
            jax.ShapeDtypeStruct((programs, _PAD), jnp.float32),
        ),
        grid=(programs,),
        out_specs=(
            pl.BlockSpec((None, _PAD, hp), lambda p: (p, 0, 0)),
            pl.BlockSpec((None, hp, _PAD), lambda p: (p, 0, 0)),
            pl.BlockSpec((None, _PAD), lambda p: (p, 0)),
        ),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps,
                                           num_stages=1),
        interpret=interpret,
        name="fieldgen_bwd",
    )(*tables, w1, tv, b1, w2p, ct)
    dw1b = jnp.sum(dw1p, axis=0)
    dsum = dw1b[3:6]  # [3, Hp]: dz1 summed over each slice's cells
    d_tables = jax.tree_util.tree_map(jnp.zeros_like, tables)
    return (
        d_tables,
        jnp.concatenate([dw1b[0:3], jnp.sum(tv * dsum, axis=0)[None]]),
        dsum * w1[3][None, :],
        jnp.sum(dsum, axis=0),
        jnp.sum(dw2p, axis=0),
        jnp.sum(db2p, axis=0),
    )


_fieldgen.defvjp(_fieldgen_fwd, _fieldgen_bwd)


def generate_fields(
    g: GridSpec,
    cfg: MLPGridConfig,
    params,
    t,
    dt=None,
    precision: str = "f32",
    z_idx=None,
) -> FieldSnapshots:
    """Fields at t-dt, t, t+dt — `models.fields.generate_fields` through
    the kernel pair, differentiable in params and t.

    z_idx (optional int array [R]): generate only these global z rows
    (already wrapped or clamped by the caller), e.g. a shard's rows plus
    its recomputed halo rows; the snapshots then have R rows along z."""
    if precision not in _TILING:
        raise ValueError(f"precision {precision!r}: expected 'f32' or 'bf16'")
    dt = g.dt if dt is None else dt
    w1, b1, w2, b2 = params["W1"], params["b1"], params["W2"], params["b2"]
    h = w1.shape[1]
    hp = _hidden_pad(h)
    cz = _axis_coord(g.nz, cfg.norm)
    if z_idx is not None:
        cz = jnp.take(cz, z_idx)
    tables = (_axis_coord(g.nx, cfg.norm), _axis_coord(g.ny, cfg.norm), cz)
    # the t channel exactly as models/fields.generate_fields builds it
    t_off = jnp.float32(0.0 if cfg.norm == CoordNorm.MinusOneToOne else 0.5)
    t = jnp.float32(t)
    dt = jnp.float32(dt)
    tvals = t_off + jnp.stack([t - dt, t, t + dt])
    tv = jnp.broadcast_to(tvals[:, None], (3, hp))
    w1p = jnp.pad(w1, ((0, 0), (0, hp - h)))
    b1p = jnp.pad(b1, (0, hp - h))
    w2p = jnp.pad(w2, ((0, hp - h), (0, _PAD - w2.shape[1])))
    b2p = jnp.pad(b2, (0, _PAD - b2.shape[0]))
    shape = (cz.shape[0], g.ny, g.nx)
    out = _fieldgen(shape, precision, pallas_interpret(), tables, w1p, tv,
                    b1p, w2p, b2p)
    y = out.reshape((3, 4) + shape)
    return FieldSnapshots(
        sigma_tm1=y[0, 0], sigma_t=y[1, 0], sigma_tp1=y[2, 0],
        u_tm1=y[0, 1:4], u_t=y[1, 1:4], u_tp1=y[2, 1:4],
    )
