"""Failure detection + auto-resume for long training runs.

SURVEY.md §5 lists "failure detection / elastic recovery" as absent from
the reference and scoped it to "restartable benchmark scripts" for this
framework; this module builds the real thing for training. A multi-hour
training job on a GPU should not lose its run to one runtime fault: a
device reset after an Xid/ECC event, a failed kernel launch, a collective
that times out when a peer process dies.

Design (three choices):

  * Checkpoint-every-K with atomic single-file .npz (train/checkpoint.py):
    a crash can never leave a half-written or manifest-skewed file, so the
    newest checkpoint is always loadable.
  * On failure the jitted step is REBUILT via a user factory: a reset
    device invalidates compiled executables and live buffers; re-tracing
    against the recovered backend is the only safe resume. Stale device
    arrays in the saved TrainState are immaterial — checkpoints restore
    from host-side npz into fresh buffers.
  * Failures are detected by exception class + message predicate, default-
    tuned to the JAX runtime errors a failing device or peer raises
    (XlaRuntimeError and friends); programming errors (shape mismatches,
    etc.) re-raise immediately rather than burning restarts.

No reference analogue (nothing distributed or restartable exists there);
the elastic-recovery checklist row this fills is SURVEY §5 "Failure
detection".
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable

import jax

from phys_autodiff_tpu.train import checkpoint


def default_failure_predicate(exc: Exception) -> bool:
    """True for exceptions that look like infrastructure failures (device
    reset, lost peer, connection loss) rather than programming errors.

    JAX surfaces these as XlaRuntimeError with messages like
    "CUDA_ERROR_LAUNCH_FAILED", "unspecified launch failure", a NCCL
    "unhandled system error", or grpc UNAVAILABLE / DEADLINE_EXCEEDED from
    the distributed runtime's coordination service. Classification requires
    BOTH an infrastructure-shaped message and a runtime-error type: a bare
    RuntimeError("anything") (e.g. a user NaN guard) or a deterministic XLA
    INTERNAL miscompile would otherwise burn the whole restart budget
    re-raising identically — retries only help failures that can heal."""
    msg = str(exc).lower()
    infra_msg = any(
        s in msg
        for s in ("unavailable", "cuda_error", "launch failure", "nccl",
                  "socket", "connection", "deadline", "crashed",
                  "restarted", "cancelled")
    )
    name = type(exc).__name__
    runtime_type = name in (
        "XlaRuntimeError", "JaxRuntimeError", "RuntimeError",
    ) or isinstance(exc, RuntimeError)
    return infra_msg and runtime_type


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    ckpt_path: str  # checkpoint file (".npz" appended if missing)
    save_every: int = 50  # optimizer steps between checkpoints
    max_restarts: int = 3  # give up after this many failures
    backoff_s: float = 0.0  # wait before a retry (device recovery time)
    is_failure: Callable[[Exception], bool] = default_failure_predicate
    meta: dict | None = None  # embedded in every checkpoint (e.g.
    # ngp.checkpoint_meta(cfg)) and validated on resume


@dataclasses.dataclass
class RunReport:
    steps_done: int = 0
    failures: int = 0
    restores: int = 0
    checkpoints: int = 0


def _to_host(state: Any) -> Any:
    """Device -> host copy so the checkpoint write cannot itself die on a
    failed device holding the buffers."""
    return jax.tree.map(lambda x: jax.device_get(x), state)


def fit_resilient(
    step_factory: Callable[[], Callable[[Any], tuple[Any, Any]]],
    state0: Any,
    steps: int,
    rcfg: ResilienceConfig,
    log: Callable[[int, float], None] | None = None,
    resume: str = "auto",
):
    """Run `steps` optimizer steps with checkpoint/auto-resume.

    step_factory() -> jitted `step(state) -> (state, loss)`; it is called
    once up front and called AGAIN after every detected failure (rebuilding
    the executable against the recovered backend). state0 is the initial
    TrainState-like pytree; its structure defines the checkpoint format.

    resume: "auto" (default) loads an existing checkpoint at ckpt_path and
    continues from it — so a PROCESS-level death (host OOM, SIGKILL) also
    resumes by simply re-running the same command; "restart" overwrites it
    and starts from state0.

    Semantics on failure: training resumes from the LAST CHECKPOINT (work
    since then is re-done — at-least-once step execution). Deterministic
    steps converge to the same trajectory; stochastic t-sampling replays
    the same PRNG stream because the key lives in the state. The checkpoint
    write and the recovery actions themselves run under the same failure
    handling as the steps (a device can fail during the state device_get or
    the post-recovery re-trace just as well as mid-step); each recovery
    attempt consumes one unit of the restart budget.

    Returns (final_state, history, report); history holds (step, loss)
    pairs at every checkpoint boundary."""
    if steps <= 0:
        return state0, [], RunReport()
    if resume not in ("auto", "restart"):
        raise ValueError(f"unknown resume mode {resume!r}")
    save_every = max(1, rcfg.save_every)

    # step counter comes from the state when it has one (TrainState.step),
    # else we track locally
    def step_no(s, fallback):
        n = getattr(s, "step", None)
        if n is None:
            return fallback
        return int(jax.device_get(n))

    report = RunReport()
    history: list[tuple[int, float]] = []
    base = step_no(state0, 0)

    def reload_state(default):
        """Last checkpoint -> (state, done); `default` when none exists.

        The completed-step count is authoritative from the manifest's
        extra["fit_done"] (written with every save), so progress survives
        failures even for state pytrees with no .step attribute — inferring
        it from state.step is only the fallback for checkpoints written by
        older versions (which lacked the counter)."""
        npz = (
            rcfg.ckpt_path
            if rcfg.ckpt_path.endswith(".npz")
            else rcfg.ckpt_path + ".npz"
        )
        if not os.path.exists(npz):
            return default, 0
        s = checkpoint.restore_npz(
            rcfg.ckpt_path, state0, expect_meta=rcfg.meta
        )
        manifest = checkpoint.read_manifest(npz)
        extra = (manifest or {}).get("extra") or {}
        if "fit_done" in extra:
            return s, max(0, int(extra["fit_done"]))
        return s, max(0, step_no(s, 0) - base)

    def save_ckpt(s, done_now):
        checkpoint.save_npz(
            rcfg.ckpt_path,
            _to_host(s),
            meta=rcfg.meta,
            extra={"fit_done": int(done_now)},
        )
        report.checkpoints += 1

    def spend_failure(exc):
        if not rcfg.is_failure(exc):
            raise exc
        report.failures += 1
        if report.failures > rcfg.max_restarts:
            raise RuntimeError(
                f"giving up after {report.failures - 1} restarts "
                f"(max_restarts={rcfg.max_restarts})"
            ) from exc
        if rcfg.backoff_s:
            time.sleep(rcfg.backoff_s)

    if resume == "auto":
        state, done = reload_state(state0)
        if done:
            report.restores += 1
    else:
        state, done = state0, 0
    step = step_factory()
    recovering = False
    while True:
        try:
            if recovering:
                # reload last checkpoint, rebuild the executable — itself
                # protected: a still-dying backend fails THIS too and
                # consumes another restart rather than killing the run
                state, done = reload_state(state0)
                step = step_factory()
                report.restores += 1
                recovering = False
            if done == 0 and report.checkpoints == 0:
                # initial checkpoint so the first failure can resume
                save_ckpt(state, done)
            if done >= steps:
                break
            burst = min(save_every, steps - done)
            for _ in range(burst):
                state, loss = step(state)
            # materialize the loss: device errors surface at fetch time
            loss_f = float(jax.device_get(loss))
            save_ckpt(state, done + burst)
        except Exception as exc:  # noqa: BLE001 — filtered by predicate
            spend_failure(exc)
            recovering = True
            continue
        done += burst
        history.append((step_no(state, done), loss_f))
        if log:
            log(step_no(state, done), loss_f)
    report.steps_done = done
    return state, history, report
