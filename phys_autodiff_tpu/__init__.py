"""phys_autodiff_tpu — differentiable-physics framework in JAX.

A JAX/XLA/Pallas re-design of the capabilities of the
`phys-autodiff` reference (a single-GPU C++23/CUDA differentiable-physics
engine in the PINN style):

  * A small MLP maps normalized space-time coordinates (x, y, z, t) to four
    physical channels [sigma, ux, uy, uz] on a dense 3D grid
    (reference: include/mlp_grid.h, src/mlp_grid.cpp).
  * A finite-difference stencil computes transport-equation residuals from
    field snapshots at t-dt, t, t+dt (reference: src/phys_cpu.cpp:25-110).
  * A weighted MSE loss over the residuals with a hand-derived first-order
    VJP g = (2 w / N) R (reference: include/phys.h:54).

Architecture:

  ref/       float64 NumPy oracle + manufactured solutions (the ground truth)
  ops/       the residual/loss path, plain JAX that XLA fuses — jnp.roll
             stencils, fully differentiable via jax.grad
  pallas/    the one hand-written kernel pair (Triton route): coordinate-MLP
             field generation whose backward recomputes the hidden
             activation instead of storing it
  backend.py the one platform dispatch (compiled kernels on a GPU,
             interpret mode on the CPU)
  models/    MLP, coordinate generation, field generation (the model family)
  parallel/  device-mesh sharding: z-axis domain decomposition with halo
             exchange (ppermute), psum loss/grad reduction
  train/     the closed training loop the reference planned but never built
             (reference REQUIREMENT.md M6): jitted value_and_grad + optax,
             checkpointing, loss-curve logging
  utils/     layouts, error metrics, tolerances, timing
  bench/     CSV benchmark harness with the reference's four timing scopes

Data layout contract (documented bijection to the reference layout):
  * The reference uses flat x-fastest arrays: idx = (z*ny + y)*nx + x
    (src/phys_cpu.cpp:17-19). Here a scalar field is a [nz, ny, nx] array;
    `field.reshape(-1)` reproduces the reference flat layout exactly.
  * Reference vector fields are channel-major [3, N] (include/phys.h:20).
    Here they are [3, nz, ny, nx]; `u.reshape(3, -1)` matches.
"""

from phys_autodiff_tpu.utils.config import (
    GridSpec,
    PhysWeights,
    MLPDims,
    CoordNorm,
    MLPGridConfig,
)

__version__ = "0.1.0"

__all__ = [
    "GridSpec",
    "PhysWeights",
    "MLPDims",
    "CoordNorm",
    "MLPGridConfig",
    "__version__",
]
