"""MLP -> physics-field generation: the model/pipeline glue layer.

Replicates the reference's mlp_grid pipeline (src/mlp_grid.cpp:53-106):
grid coords at t-dt, t, t+dt -> MLP inference -> split the 4 output channels
into sigma [nz,ny,nx] and channel-major u [3,nz,ny,nx].

Differences from the reference:
  * The three time slices are evaluated as ONE batched MLP call over
    [3, nz, ny, nx, 4] coordinates (the reference launches three separate
    inference passes and re-uploads the weights each time,
    src/mlp_grid.cpp:100-102, src/mlp_cuda.cu:94-106).
  * Everything is traced: under jit the coord build, MLP matmuls, and channel
    split fuse into one XLA program; nothing round-trips to the host.
  * Differentiable end to end: jax.grad reaches the MLP weights through the
    generated fields — the closed training loop the reference planned but
    never built (REQUIREMENT.md M6).
"""

from __future__ import annotations

import jax.numpy as jnp

from phys_autodiff_tpu.models import mlp
from phys_autodiff_tpu.models.coords import grid_coords
from phys_autodiff_tpu.ops.stencil import FieldSnapshots
from phys_autodiff_tpu.utils.config import GridSpec, MLPGridConfig


def grid_infer(g: GridSpec, cfg: MLPGridConfig, params: mlp.Params, t):
    """MLP over the grid at time t -> [nz, ny, nx, Out].

    Reference: mlp_grid_infer_* (src/mlp_grid.cpp:53-67); reshaping to
    [N, Out] reproduces the reference output array exactly.
    """
    coords = grid_coords(g, t, cfg.norm)
    return mlp.forward(params, coords)


def split_channels(y: jnp.ndarray):
    """[... , nz, ny, nx, 4] -> sigma [..., nz,ny,nx], u [..., 3, nz,ny,nx].

    Channel order [sigma, ux, uy, uz] (include/mlp_grid.h:16,
    src/mlp_grid.cpp:74-78).
    """
    sigma = y[..., 0]
    u = jnp.moveaxis(y[..., 1:4], -1, -4)
    return sigma, u


def generate_fields(
    g: GridSpec, cfg: MLPGridConfig, params: mlp.Params, t, dt,
    precision: str = "f32",
) -> FieldSnapshots:
    """Fields at t-dt, t, t+dt from one batched MLP evaluation
    (`precision`: see mlp.forward).

    Reference: mlp_generate_fields_* (src/mlp_grid.cpp:82-106).
    """
    ts = jnp.stack(
        [jnp.float32(t) - jnp.float32(dt), jnp.float32(t), jnp.float32(t) + jnp.float32(dt)]
    )
    # One [3, nz, ny, nx, 4] coordinate tensor; the spatial part is shared and
    # broadcast, only the t channel differs per slice.
    base = grid_coords(g, 0.0, cfg.norm)  # t channel filled below
    spatial = base[..., :3]
    t_off = base[..., 3]  # 0.0 or 0.5 depending on the norm quirk
    coords = jnp.concatenate(
        [
            jnp.broadcast_to(spatial[None], (3,) + spatial.shape),
            (t_off[None] + ts[:, None, None, None])[..., None],
        ],
        axis=-1,
    )
    y = mlp.forward(params, coords, precision)  # [3, nz, ny, nx, 4]
    sigma, u = split_channels(y)  # [3, nz,ny,nx], [3, 3, nz,ny,nx]
    return FieldSnapshots(
        sigma_tm1=sigma[0],
        sigma_t=sigma[1],
        sigma_tp1=sigma[2],
        u_tm1=u[0],
        u_t=u[1],
        u_tp1=u[2],
    )
