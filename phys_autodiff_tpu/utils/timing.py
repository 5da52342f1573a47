"""Tracing / profiling utilities.

Counterparts of the reference's instrumentation (survey §5): the
reference brackets kernels with CUDA events (src/phys_cuda_nonfused.cu:
322-345) and E2E scopes with steady_clock (test/test_phys_perf.cpp:46-53).
Here:

  * `trace(path)` — context manager around jax.profiler for full device
    traces (view with TensorBoard / Perfetto).
  * `annotate(name)` — profiler TraceAnnotation for labeling pipeline scopes
    (the kernel / phys-E2E / mlp / total taxonomy).
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def trace(log_dir: str, perfetto: bool = False):
    """Capture a jax.profiler device trace into log_dir. perfetto=True also
    writes a parseable perfetto trace.json.gz (plugins/profile/*/ *.json.gz)."""
    jax.profiler.start_trace(log_dir, create_perfetto_trace=perfetto)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named scope that shows up in profiler traces."""
    return jax.profiler.TraceAnnotation(name)
