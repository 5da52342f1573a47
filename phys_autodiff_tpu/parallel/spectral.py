"""Distributed FFT Helmholtz projection — pencil decomposition over the mesh.

`ops/projection.py::project_fft` needs a full 3-D spectrum, but fields on
the mesh are z-sharded and no chip ever holds the global grid. The classic
answer is the pencil (transpose) decomposition, built here from
exactly two `jax.lax.all_to_all` collectives per solve:

    [nz/n, ny, nx]   rfft x, fft y      (shard-local: those axes are whole)
        -> all_to_all (split y, concat z)  ->  [nz, ny/n, nx/2+1]
    fft z, apply the central-difference symbol, ifft z
        -> all_to_all (split z, concat y)  ->  [nz/n, ny, nx/2+1]
    ifft y, irfft x                      (shard-local again)

Both transposes ride the ICI; everything else is local FFT + elementwise
work. The divergence in and the pressure gradient out need only the
familiar +-1-plane z halo (`parallel.sharded._halo_extend_z` — the same
ppermute the residual kernels ride), so a full projection costs two
all_to_alls + two 2-plane halo exchanges, independent of grid size.

The arithmetic matches the single-chip projector mode-for-mode (same
symbol, same Nyquist masking); parity is tolerance-level (~1e-6 rel), not
bitwise, because the factored per-axis FFT evaluates in a different order
than the fused rfftn. Requires nz % n == 0 and ny % n == 0.

`shard_local_project_fft(g, n)` returns the per-shard function for embedding
in larger shard_map programs (the sharded Euler step, apps/euler.py);
`project_fft_sharded(g, u, mesh)` is the standalone entry.
`shard_local_diffuse_fft(g, n, c, dt)` pencil-decomposes ops.diffusion's
exact periodic implicit solve the same way (the symbol is separable, so
each pencil rebuilds its y chunk from the 1-D pieces).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from phys_autodiff_tpu.ops.projection import _central_symbols
from phys_autodiff_tpu.ops.stencil import inv2h_f32
from phys_autodiff_tpu.parallel.mesh import Z_AXIS
from phys_autodiff_tpu.parallel.sharded import _halo_extend_z
from phys_autodiff_tpu.utils.config import GridSpec


def _pencil_rfft3(f_local: jnp.ndarray) -> jnp.ndarray:
    """Forward 3-D rfft of a z-sharded real field via one all_to_all:
    [nz/n, ny, nx] -> spectrum pencil [nz, ny/n, nx/2+1]."""
    h = jnp.fft.rfft(f_local, axis=2)
    h = jnp.fft.fft(h, axis=1)
    h = jax.lax.all_to_all(h, Z_AXIS, split_axis=1, concat_axis=0,
                           tiled=True)
    return jnp.fft.fft(h, axis=0)


def _pencil_irfft3(h: jnp.ndarray, nx: int) -> jnp.ndarray:
    """Inverse of `_pencil_rfft3`: [nz, ny/n, nx/2+1] -> [nz/n, ny, nx]."""
    h = jnp.fft.ifft(h, axis=0)
    h = jax.lax.all_to_all(h, Z_AXIS, split_axis=0, concat_axis=1,
                           tiled=True)
    h = jnp.fft.ifft(h, axis=1)
    return jnp.fft.irfft(h, n=nx, axis=2)


def _slice_y(vec_b: jnp.ndarray, ny_local: int) -> jnp.ndarray:
    """This shard's y chunk of a [1, ny, 1]-broadcast spectral vector."""
    idx = jax.lax.axis_index(Z_AXIS)
    return jax.lax.dynamic_slice_in_dim(
        vec_b.reshape(-1), idx * ny_local, ny_local
    )[None, :, None]


def _halo_zdiff(f_local: jnp.ndarray, inv2h: float) -> jnp.ndarray:
    """Central z-difference of a local [nz/n, ny, nx] slab via the 2-plane
    ppermute halo (periodic — the FFT projector's precondition)."""
    ext = _halo_extend_z(f_local, periodic=True)
    return (ext[2:] - ext[:-2]) * inv2h


def _local_xydiff(f: jnp.ndarray, axis: int, inv2h: float) -> jnp.ndarray:
    """Shard-local periodic central difference along a whole axis (x or y)."""
    return (jnp.roll(f, -1, axis=axis) - jnp.roll(f, 1, axis=axis)) * inv2h


def shard_local_project_fft(g: GridSpec, n: int):
    """Build the per-shard projection body for an n-way z-sharded mesh.

    Returns project(u_local: [3, nz/n, ny, nx]) -> same shape, to be called
    INSIDE shard_map over the Z_AXIS mesh. Collective footprint per call:
    2 ppermute halo exchanges (div in, grad out) + 2 all_to_all transposes.
    """
    assert g.periodic, "spectral projection requires periodic boundaries"
    assert g.nz % n == 0 and g.ny % n == 0, (g.shape, n)
    ny_local = g.ny // n
    sz_b, sy_b, sx_b = _central_symbols(g)
    sy_flat = sy_b.reshape(-1)  # [ny], sliced per shard below

    def project(u_local: jnp.ndarray) -> jnp.ndarray:
        # --- divergence (same arithmetic as ops.diagnostics.divergence)
        d = (
            _local_xydiff(u_local[0], 2, inv2h_f32(g.hx))
            + _local_xydiff(u_local[1], 1, inv2h_f32(g.hy))
            + _halo_zdiff(u_local[2], inv2h_f32(g.hz))
        )
        # --- Poisson solve under the wide central-difference symbol
        h = _pencil_rfft3(d)
        sy_loc = _slice_y(sy_flat, ny_local)
        lap = -(sx_b * sx_b + sy_loc * sy_loc + sz_b * sz_b)
        h = jnp.where(lap != 0.0, h / jnp.where(lap != 0.0, lap, 1.0), 0.0)
        p = _pencil_irfft3(h, g.nx).astype(u_local.dtype)
        # --- u - grad p (x/y local rolls, z via the halo)
        gp = jnp.stack([
            _local_xydiff(p, 2, inv2h_f32(g.hx)),
            _local_xydiff(p, 1, inv2h_f32(g.hy)),
            _halo_zdiff(p, inv2h_f32(g.hz)),
        ])
        return u_local - gp

    return project


def shard_local_diffuse_fft(g: GridSpec, n: int, c: float, dt: float):
    """Build the per-shard implicit-diffusion body (ops.diffusion's exact
    periodic solve, pencil-decomposed): diffuse(f_local [..., nz/n, ny, nx])
    -> same shape. Leading axes (e.g. the 3 velocity components) are mapped
    one pencil solve each. Two all_to_alls per scalar per call."""
    assert g.periodic, "spectral diffusion requires periodic boundaries"
    assert g.nz % n == 0 and g.ny % n == 0, (g.shape, n)
    import numpy as np

    ny_local = g.ny // n
    cdt = float(c) * float(dt)

    # the compact symbol is separable (sz + sy + sx) — carry the 1-D pieces
    # and rebuild this pencil's y chunk in-kernel (ops.diffusion's
    # _compact_symbol, factored)
    def s_of(k, nn, h):
        s = np.sin(np.pi * k / nn) / h
        return (4.0 * s * s).astype(np.float32)

    sz = jnp.asarray(s_of(np.fft.fftfreq(g.nz) * g.nz, g.nz, g.hz))
    sy = jnp.asarray(s_of(np.fft.fftfreq(g.ny) * g.ny, g.ny, g.hy))
    sx = jnp.asarray(s_of(np.fft.rfftfreq(g.nx) * g.nx, g.nx, g.hx))

    def diffuse_scalar(f_local: jnp.ndarray) -> jnp.ndarray:
        h = _pencil_rfft3(f_local)
        lam_local = (
            sz[:, None, None]
            + _slice_y(sy.reshape(1, -1, 1), ny_local)
            + sx[None, None, :]
        )
        h = h / (1.0 + jnp.float32(cdt) * lam_local)
        return _pencil_irfft3(h, g.nx).astype(f_local.dtype)

    def diffuse(f_local: jnp.ndarray) -> jnp.ndarray:
        if f_local.ndim == 3:
            return diffuse_scalar(f_local)
        assert f_local.ndim == 4, f_local.shape
        return jnp.stack([diffuse_scalar(f_local[i])
                          for i in range(f_local.shape[0])])

    return diffuse


def project_fft_sharded(g: GridSpec, u: jnp.ndarray, mesh) -> jnp.ndarray:
    """Standalone distributed projection: u [3, nz, ny, nx] (any sharding)
    -> divergence-free u, z-sharded over the mesh. Matches the single-chip
    `ops.projection.project_fft` to fp tolerance."""
    assert u.shape == (3,) + g.shape, (u.shape, g.shape)
    n = mesh.shape[Z_AXIS]
    body = shard_local_project_fft(g, n)
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=P(None, Z_AXIS),
        out_specs=P(None, Z_AXIS),
        check_vma=False,
    )
    u = jax.device_put(u, NamedSharding(mesh, P(None, Z_AXIS)))
    return jax.jit(fn)(u)
