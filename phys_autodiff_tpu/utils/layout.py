"""Layout bijection between this framework's arrays and the reference flat layout.

Reference layout contract (include/phys.h:20-21, src/phys_cpu.cpp:17-23):
  * scalar field: flat length-N float array, idx = (z*ny + y)*nx + x
  * vector field: channel-major flat [3*N]: [ux(0..N-1), uy(...), uz(...)]

Layout here:
  * scalar field: [nz, ny, nx] (x fastest in memory → C-order reshape is the
    exact reference layout)
  * vector field: [3, nz, ny, nx]

These helpers exist so tests and interop code can move between the two
without ever getting the bijection wrong.
"""

from __future__ import annotations

import numpy as np

from phys_autodiff_tpu.utils.config import GridSpec


def scalar_to_flat(f) -> np.ndarray:
    """[nz, ny, nx] -> flat [N] in reference order."""
    return np.asarray(f).reshape(-1)


def scalar_from_flat(flat, g: GridSpec) -> np.ndarray:
    """flat [N] in reference order -> [nz, ny, nx]."""
    return np.asarray(flat).reshape(g.shape)


def vector_to_flat(u) -> np.ndarray:
    """[3, nz, ny, nx] -> flat channel-major [3*N]."""
    return np.asarray(u).reshape(-1)


def vector_from_flat(flat, g: GridSpec) -> np.ndarray:
    """flat channel-major [3*N] -> [3, nz, ny, nx]."""
    return np.asarray(flat).reshape((3,) + g.shape)
