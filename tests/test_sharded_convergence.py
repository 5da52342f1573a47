"""Multi-step sharded CONVERGENCE on the 8-device mesh.

The sharding tests pin 1-3-step parity; this file proves distribution over a
TRAJECTORY: the reference's M6 acceptance criterion — training must drop the
physics loss >= 90% within the budgeted steps
(reference REQUIREMENT.md:164-169) — demonstrated ON THE MESH, for
both distribution arms:

  * the GSPMD staged step (XLA inserts halo collectives + grad all-reduce)
  * the shard_map fused step generating each shard's rows and recomputed
    halo rows with the kernel pair of pallas/fieldgen.py (interpret mode on
    the CPU mesh)

and, as the cross-check that the distributed trajectory IS the single-chip
trajectory, the sharded loss sequence is compared step-by-step against the
unsharded fused step from the same init.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phys_autodiff_tpu.models import mlp
from phys_autodiff_tpu.parallel import (
    make_mesh,
    make_sharded_fused_train_step,
    make_sharded_train_step,
)
from phys_autodiff_tpu.utils.config import (
    GridSpec,
    MLPDims,
    MLPGridConfig,
    PhysWeights,
)

N_DEV = 8
G = GridSpec(nx=16, ny=16, nz=16, hx=0.4, hy=0.4, hz=0.4, dt=1e-2)
W = PhysWeights()
MCFG = MLPGridConfig(dims=MLPDims(H=32))


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= N_DEV, "conftest must provide 8 CPU devices"
    return make_mesh(N_DEV)


def test_gspmd_sharded_training_drops_90_percent(mesh):
    step, init = make_sharded_train_step(G, W, MCFG, mesh, learning_rate=3e-3)
    params, opt_state = init(mlp.init_params(MCFG.dims, seed=1))
    t = jnp.float32(0.25)
    first = None
    for i in range(300):
        params, opt_state, loss = step(params, opt_state, t)
        # Fetch the loss EVERY step to bound in-flight executions at 1.
        # 300 un-synchronized async dispatches of an 8-device program
        # abort the CPU PJRT client (SIGABRT) once the process has prior
        # executed programs — a runtime resource limit, reproduced with
        # any single test file run before this one. The framework's own
        # loops (train/loop.py, train/resilient.py) fetch per burst and
        # never dispatch unboundedly.
        last = float(loss)
        if first is None:
            first = last
    assert np.isfinite(last)
    assert last <= 0.1 * first, f"sharded loss only dropped {first} -> {last}"


def test_shardmap_fused_training_drops_90_percent_and_matches_single(mesh):
    """The fused shard_map arm converges >= 90% AND its per-step losses sit
    on the single-device trajectory of the same step (a 1-device mesh: same
    per-plane programs and fixed-order loss chain; only the gradient psum
    associates differently) at 1e-5 rel per step."""
    steps = 150
    lr = 3e-3
    t = jnp.float32(0.25)
    runs = {}
    for n in (N_DEV, 1):
        step, init = make_sharded_fused_train_step(
            G, W, MCFG, mesh if n == N_DEV else make_mesh(1), learning_rate=lr
        )
        params, opt_state = init(mlp.init_params(MCFG.dims, seed=1))
        losses = []
        for _ in range(steps):
            params, opt_state, loss = step(params, opt_state, t)
            losses.append(float(loss))  # bounds in-flight executions at 1
        runs[n] = losses
    for i, (ln, l1) in enumerate(zip(runs[N_DEV], runs[1])):
        assert abs(ln - l1) <= 1e-5 * max(abs(l1), 1e-6), (i, ln, l1)
    first, last = runs[N_DEV][0], runs[N_DEV][-1]
    assert np.isfinite(last)
    assert last <= 0.1 * first, f"fused sharded loss only dropped {first} -> {last}"
