"""MLP gradient comparison CLI.

Port of the reference's test_mlp_compare (test/test_mlp_compare.cpp — the
only argv-configurable executable in the reference, :17-25): compares the
framework's jax.grad MLP gradients against the hand-derived NumPy reference
gradients and reports per-tensor max_abs_diff plus timings. Unlike the
reference (observational only, :58-71), this exits nonzero on mismatch.

Usage:
    PYTHONPATH=.:$PYTHONPATH python scripts/mlp_compare.py [B] [In] [H] [Out]
Defaults: B=512 In=256 H=512 Out=256 (the reference's defaults).
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from phys_autodiff_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from phys_autodiff_tpu.models import mlp
from phys_autodiff_tpu.ref import mlp_oracle
from phys_autodiff_tpu.utils.config import MLPDims
from phys_autodiff_tpu.utils.metrics import max_abs_err, rel_l2_err


def main(argv):
    b = int(argv[1]) if len(argv) > 1 else 512
    in_dim = int(argv[2]) if len(argv) > 2 else 256
    h = int(argv[3]) if len(argv) > 3 else 512
    out = int(argv[4]) if len(argv) > 4 else 256

    dims = MLPDims(In=in_dim, H=h, Out=out)
    params = mlp.init_params(dims, seed=7, scale=0.1)
    rng = np.random.default_rng(31)
    x = rng.uniform(-1, 1, size=(b, in_dim)).astype(np.float32)
    y_t = rng.uniform(-1, 1, size=(b, out)).astype(np.float32)

    t0 = time.perf_counter()
    ref_grads = mlp_oracle.mse_backward(mlp.to_reference_layout(params), x, y_t)
    cpu_ms = (time.perf_counter() - t0) * 1e3

    grads_fn = jax.jit(mlp.mse_grads)
    g = grads_fn(params, jnp.asarray(x), jnp.asarray(y_t))  # compile
    t0 = time.perf_counter()
    g = grads_fn(params, jnp.asarray(x), jnp.asarray(y_t))
    _ = float(jax.tree_util.tree_leaves(g)[0].reshape(-1)[0])
    dev_ms = (time.perf_counter() - t0) * 1e3

    g_ref_layout = mlp.to_reference_layout(g)
    ok = True
    for k in ["W1", "b1", "W2", "b2"]:
        diff = max_abs_err(g_ref_layout[k], ref_grads[k])
        rel = rel_l2_err(g_ref_layout[k], ref_grads[k])
        status = "OK" if rel <= 1e-5 else "MISMATCH"
        ok &= rel <= 1e-5
        print(f"d{k}: max_abs_diff={diff:.3e} rel_l2={rel:.3e} [{status}]")
    print(f"B={b} In={in_dim} H={h} Out={out} "
          f"numpy_ms={cpu_ms:.2f} device_ms={dev_ms:.2f}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
