"""Shared test helpers."""

import numpy as np

from phys_autodiff_tpu.models.coords import grid_coords


def relu_kink_margin(g, params, t, norm=None) -> float:
    """Smallest |z1| / (sum of |terms| of z1) over every cell, hidden unit
    and time slice of the coordinate MLP's layer 1, in f64.

    Two f32 programs that sum layer 1 in different orders agree on a
    pre-activation only to a few ulp; where one lies that close to zero
    they can take opposite sides of the ReLU, and the whole cotangent of
    that unit and cell enters one gradient and not the other. A parity
    test between two such arms is meaningful only when this margin is
    well above f32 rounding (about 1e-7)."""
    kw = {} if norm is None else {"norm": norm}
    w1 = np.asarray(params["W1"], np.float64)
    b1 = np.asarray(params["b1"], np.float64)
    margin = np.inf
    for tt in (t - g.dt, t, t + g.dt):
        c = np.asarray(grid_coords(g, tt, **kw), np.float64).reshape(-1, 4)
        z = c @ w1 + b1
        scale = np.abs(c) @ np.abs(w1) + np.abs(b1)
        margin = min(margin, float(np.min(np.abs(z) / scale)))
    return margin
