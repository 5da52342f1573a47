"""Float64 PARAMETER-GRADIENT oracle for the field-model physics losses.

`ref/oracle.py` adjudicates forward values (residuals/losses) in float64;
this module adjudicates GRADIENTS: independent float64 replicas of the
staged pipelines (field model -> residuals -> weighted MSE), differentiated
with jax.grad under x64. It exists because comparing two float32 gradient
implementations against each other (the kernel pair's backward vs jax.grad
of the staged path) cannot tell WHICH one an observed gap belongs to — in
clamp mode the loss is small with near-cancelling gradient contributions,
and BOTH f32 arms sit ~1e-3 from the true gradient while agreeing with
each other only to ~2e-4 (measured on the CPU, 32x16x8 clamp H=32). The f64
arm is the referee: an arm whose distance to the truth is no worse than
jax.grad's own is correct.

Covered field models:

  * `f64_loss_and_grad` — the coordinate MLP (models/fields.generate_fields
    semantics), both coordinate norms (the ZeroToOne arm carries the
    reference's t+0.5 time-channel quirk, src/mlp_grid.cpp:38 — passing
    the wrong norm would silently grade the gradient of a DIFFERENT
    function, so the norm is an explicit argument).
  * `f64_encoded_loss_and_grad` — the encoded families
    (ngp.generate_fields semantics): the NGP dense/hash multiresolution
    encoder and the Fourier positional encoder, through the 2-layer decode
    head. Gradients cover the FULL params pytree including the encoder
    tables.

Both cover the central AND upwind schemes (the upwind advection replica
chooses one-sided differences by the same velocity-sign predicate as
ops/stencil.upwind_diff — identical branches, since the widened f64
velocities equal the f32 values exactly).

Scalar constants everywhere are the float32-ROUNDED values promoted to
f64 (step reciprocals, resample weights, coordinates, frequencies), so the
truth differentiates exactly the function the f32 arms evaluate.

Validation only: the tests run it on the CPU, chip_smoke.py on the card.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from phys_autodiff_tpu.utils.config import CoordNorm, GridSpec, PhysWeights


def _axis_coord_f32_values(n: int, norm: CoordNorm) -> np.ndarray:
    """Axis coordinates with the f32-rounded VALUES the f32 pipeline sees
    (models/coords._axis_coord), widened to f64."""
    if n <= 1:
        return np.zeros((max(n, 1),), np.float64)
    u = np.arange(n, dtype=np.float32) / np.float32(n - 1)
    if norm == CoordNorm.ZeroToOne:
        return u.astype(np.float64)
    # 2u - 1 is computed IN f32 (like models/coords._axis_coord) before
    # widening: for u < 0.25 the subtraction rounds, and the oracle must
    # differentiate the function evaluated at the f32 pipeline's inputs.
    return (np.float32(2.0) * u - np.float32(1.0)).astype(np.float64)


def _f64_stencil_loss(g: GridSpec, w: PhysWeights):
    """loss_of(fields) -> scalar f64, where fields = [(sigma, u) x 3 time
    slices] in f64. The shared residual+loss tail of every referee:
    central (or upwind) residuals with f32-rounded step constants, then
    the weighted mean-square reduction."""
    assert g.scheme in ("central", "upwind")
    # f32-rounded step reciprocals, as the f32 arms compute them
    inv2 = {
        a: np.float64(np.float32(1.0 / (2.0 * float(np.float32(h)))))
        for a, h in (("x", g.hx), ("y", g.hy), ("z", g.hz), ("t", g.dt))
    }
    inv1 = {
        a: np.float64(np.float32(1.0 / float(np.float32(h))))
        for a, h in (("x", g.hx), ("y", g.hy), ("z", g.hz))
    }
    per = g.periodic

    def shift(f, d, axis):
        if per:
            return jnp.roll(f, -d, axis)
        n = f.shape[axis]
        return jnp.take(f, np.clip(np.arange(n) + d, 0, n - 1), axis)

    def cdiff(f, axis, s):
        return (shift(f, 1, axis) - shift(f, -1, axis)) * s

    def updiff(f, a, axis, s):
        bwd = (f - shift(f, -1, axis)) * s
        fwd = (shift(f, 1, axis) - f) * s
        return jnp.where(a > 0.0, bwd, fwd)

    def loss_of(fields):
        (s0, u0), (s1, u1), (s2, u2) = fields
        dts = (s2 - s0) * inv2["t"]
        dtu = (u2 - u0) * inv2["t"]
        du = [cdiff(u1, a + 1, inv2[n]) for a, n in ((2, "x"), (1, "y"), (0, "z"))]
        div_u = du[0][0] + du[1][1] + du[2][2]  # central in both schemes
        if g.scheme == "upwind":
            def adv(f):
                return (
                    u1[0] * updiff(f, u1[0], f.ndim - 1, inv1["x"])
                    + u1[1] * updiff(f, u1[1], f.ndim - 2, inv1["y"])
                    + u1[2] * updiff(f, u1[2], f.ndim - 3, inv1["z"])
                )

            adv_s = adv(s1)
            adv_u = jnp.stack([adv(u1[0]), adv(u1[1]), adv(u1[2])])
        else:
            ds = [cdiff(s1, a, inv2[n]) for a, n in ((2, "x"), (1, "y"), (0, "z"))]
            adv_s = u1[0] * ds[0] + u1[1] * ds[1] + u1[2] * ds[2]
            adv_u = u1[0][None] * du[0] + u1[1][None] * du[1] + u1[2][None] * du[2]
        r_s = dts + adv_s + s1 * div_u
        r_u = dtu + adv_u
        n_cells = np.float64(g.num_cells)
        return (
            np.float64(w.w_sigma) * jnp.sum(r_s * r_s) / n_cells
            + np.float64(w.w_u) * jnp.sum(r_u * r_u) / n_cells
        )

    return loss_of


def f64_fields_fn(
    g: GridSpec, norm: CoordNorm = CoordNorm.MinusOneToOne
):
    """fields(params64, t) -> [(sigma, u) x 3 time slices] in f64: the
    coordinate MLP's snapshots at t-dt, t, t+dt (call inside
    `jax.enable_x64`). Semantics mirror models/fields.generate_fields;
    ZeroToOne's time channel carries the reference's +0.5 quirk
    (models/coords.grid_coords; src/mlp_grid.cpp:38)."""
    xs = np.broadcast_to(
        _axis_coord_f32_values(g.nx, norm)[None, None, :], g.shape
    )
    ys = np.broadcast_to(
        _axis_coord_f32_values(g.ny, norm)[None, :, None], g.shape
    )
    zs = np.broadcast_to(
        _axis_coord_f32_values(g.nz, norm)[:, None, None], g.shape
    )
    spatial = jnp.asarray(np.stack([xs, ys, zs], axis=-1))  # [nz, ny, nx, 3]

    def fields(params64, t):
        t = jnp.asarray(t, jnp.float64)
        dt = jnp.float64(np.float32(g.dt))
        out = []
        for tt in (t - dt, t, t + dt):
            tch = tt + 0.5 if norm == CoordNorm.ZeroToOne else tt
            co = jnp.concatenate(
                [spatial, jnp.broadcast_to(tch, g.shape)[..., None]], -1
            )
            z1 = co @ params64["W1"] + params64["b1"]
            y = jnp.maximum(z1, 0.0) @ params64["W2"] + params64["b2"]
            out.append((y[..., 0], jnp.moveaxis(y[..., 1:4], -1, 0)))
        return out

    return fields


def f64_loss_fn(
    g: GridSpec, w: PhysWeights, norm: CoordNorm = CoordNorm.MinusOneToOne
):
    """loss(params64, t) -> scalar f64 for the coordinate MLP;
    differentiate with jax.grad inside `jax.enable_x64`. Semantics mirror
    models/fields.generate_fields + ops.residuals + ops.total_loss
    (central or upwind per g.scheme). `norm` must match the pipeline under
    adjudication."""
    fields = f64_fields_fn(g, norm)
    loss_of = _f64_stencil_loss(g, w)
    return lambda params64, t: loss_of(fields(params64, t))


def f64_loss_and_grad(
    g: GridSpec,
    w: PhysWeights,
    params,
    t,
    norm: CoordNorm = CoordNorm.MinusOneToOne,
):
    """(loss64, grads64): the float64 truth for f32 `params` at time `t`.

    Safe to call from an f32 process: x64 is enabled only around the f64
    trace/execution (the jax.enable_x64 scoped context), and the params
    are widened first so no value changes."""
    with jax.enable_x64():
        params64 = {
            k: jnp.asarray(np.asarray(v), np.float64) for k, v in params.items()
        }
        loss = f64_loss_fn(g, w, norm=norm)
        l64, gp64 = jax.value_and_grad(loss)(params64, float(t))
        return float(l64), {k: np.asarray(v) for k, v in gp64.items()}


# ---------------------------------------------------------------------------
# Encoded families: NGP (dense/hash multiresolution) and Fourier
# ---------------------------------------------------------------------------


def _f64_resample_matrix(n: int, r: int) -> np.ndarray:
    """hash_encoder._resample_matrix's f32-ROUNDED weights widened to f64 —
    the f32 arms contract with the f32 matrix, so the truth must too."""
    from phys_autodiff_tpu.models.hash_encoder import _resample_matrix

    return _resample_matrix(n, r).astype(np.float64)


def _f64_encode_hash_grid(enc_cfg, tables64, g: GridSpec):
    """f64 replica of hash_encoder.encode_grid: per level, gather the
    (r+1)^3 corner lattice (hash levels: the same trace-time numpy hash
    indices; dense levels: the parameters ARE the lattice), then three
    separable axis resamples with the f32-rounded interpolation weights.
    -> [nz, ny, nx, L*F]."""
    from phys_autodiff_tpu.models.hash_encoder import _PRIMES, _tables_view

    nz, ny, nx = g.shape
    hash_tables, dense = _tables_view(enc_cfg, tables64)
    hash_pos = {l: i for i, l in enumerate(enc_cfg.hash_levels())}
    outs = []
    for lvl, r in enumerate(enc_cfg.level_resolutions()):
        r = int(r)
        if lvl in dense:
            corner = dense[lvl]  # [r+1, r+1, r+1, F] f64 params
        else:
            ii = np.arange(r + 1, dtype=np.uint32)
            hx = ii * np.uint32(_PRIMES[0])
            hy = ii * np.uint32(_PRIMES[1])
            hz = ii * np.uint32(_PRIMES[2])
            h = hz[:, None, None] ^ hy[None, :, None] ^ hx[None, None, :]
            idx = (h & np.uint32(enc_cfg.table_size - 1)).astype(np.int32)
            corner = jnp.take(
                hash_tables[hash_pos[lvl]], jnp.asarray(idx.ravel()), axis=0
            ).reshape(r + 1, r + 1, r + 1, enc_cfg.features_per_level)
        lev = corner
        for axis, n in ((0, nz), (1, ny), (2, nx)):
            m = jnp.asarray(_f64_resample_matrix(n, r))  # [r+1, n]
            lev = jnp.moveaxis(
                jnp.tensordot(lev, m, axes=([axis], [0])), -1, axis
            )
        outs.append(lev)
    return jnp.concatenate(outs, axis=-1)


def _f64_encode_fourier_grid(enc_cfg, g: GridSpec):
    """f64 replica of fourier.encode_grid: per-axis [raw?, sin, cos]
    features at the f32-rounded grid coordinates and f32-rounded
    frequencies, sin/cos evaluated in f64 (the truth of the exact math at
    the f32 arms' inputs). -> [nz, ny, nx, out_dim] (constant — no
    parameters)."""
    nz, ny, nx = g.shape

    def axis_feats(n):
        v = _axis_coord_f32_values(n, CoordNorm.ZeroToOne)  # f32 values, f64
        feats = []
        if enc_cfg.include_input:
            feats.append(v)
        for k in range(enc_cfg.num_frequencies):
            wk = np.float64(np.float32(np.pi * (2.0**k)))
            feats.append(np.sin(wk * v))
            feats.append(np.cos(wk * v))
        return np.stack(feats, axis=-1)  # [n, C]

    fx, fy, fz = axis_feats(nx), axis_feats(ny), axis_feats(nz)
    c = enc_cfg.axis_dim
    return jnp.asarray(np.concatenate(
        [
            np.broadcast_to(fx[None, None, :, :], (nz, ny, nx, c)),
            np.broadcast_to(fy[None, :, None, :], (nz, ny, nx, c)),
            np.broadcast_to(fz[:, None, None, :], (nz, ny, nx, c)),
        ],
        axis=-1,
    ))


def f64_encoded_loss_fn(g: GridSpec, w: PhysWeights, ncfg):
    """loss(params64, t) -> scalar f64 for an encoded field model
    (ngp.NGPFieldConfig with a Hash or Fourier encoding); differentiate
    with jax.grad inside `jax.enable_x64`. Semantics mirror
    ngp.generate_fields + ops.residuals + ops.total_loss: encoding shared
    across the three time slices (time enters only through the head's last
    input channel), 2-layer relu head, central or upwind residuals."""
    from phys_autodiff_tpu.models.fourier import FourierEncodingConfig

    loss_of = _f64_stencil_loss(g, w)
    is_fourier = isinstance(ncfg.encoding, FourierEncodingConfig)
    fourier_enc = (
        _f64_encode_fourier_grid(ncfg.encoding, g) if is_fourier else None
    )

    def loss(params64, t):
        t = jnp.asarray(t, jnp.float64)
        dt = jnp.float64(np.float32(g.dt))
        if is_fourier:
            enc = fourier_enc
        else:
            enc = _f64_encode_hash_grid(ncfg.encoding, params64["tables"], g)
        fields = []
        for tt in (t - dt, t, t + dt):
            co = jnp.concatenate(
                [enc, jnp.broadcast_to(tt, g.shape)[..., None]], -1
            )
            z1 = co @ params64["W1"] + params64["b1"]
            y = jnp.maximum(z1, 0.0) @ params64["W2"] + params64["b2"]
            fields.append((y[..., 0], jnp.moveaxis(y[..., 1:4], -1, 0)))
        return loss_of(fields)

    return loss


def f64_encoded_loss_and_grad(g: GridSpec, w: PhysWeights, ncfg, params, t):
    """(loss64, grads64) for an encoded field model: the float64 truth for
    f32 `params` (full pytree, encoder tables included) at time `t`.
    grads64 is a pytree of numpy arrays matching `params`."""
    with jax.enable_x64():
        params64 = jax.tree_util.tree_map(
            lambda v: jnp.asarray(np.asarray(v), np.float64), params
        )
        loss = f64_encoded_loss_fn(g, w, ncfg)
        l64, gp64 = jax.value_and_grad(loss)(params64, float(t))
        return float(l64), jax.tree_util.tree_map(np.asarray, gp64)
