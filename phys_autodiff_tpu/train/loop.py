"""The closed training loop: MLP weights optimized against the physics loss.

The reference planned this as Goal B / milestone M6 (REQUIREMENT.md:11,
155-169: "physics-only training", loss must drop >= 90% in K steps) but never
built it — its MLP backward hard-codes an MSE-vs-target head with no way to
inject the physics VJP (src/mlp_cuda.cu:123-184, survey §3.5). Here the whole
chain MLP -> fields -> residuals -> loss is differentiable, so the loop is
one jax.value_and_grad plus an optax update, jitted end to end.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import optax

from phys_autodiff_tpu import ops
from phys_autodiff_tpu.models import fields as fields_mod
from phys_autodiff_tpu.models import mlp
from phys_autodiff_tpu.utils.config import GridSpec, MLPGridConfig, PhysWeights


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 200
    learning_rate: float = 1e-3
    optimizer: str = "adam"  # "adam" | "adamw" | "sgd"
    weight_decay: float = 0.0  # decoupled weight decay (optimizer="adamw")
    grad_clip: float = 0.0  # global-norm gradient clip; 0 disables
    lr_schedule: str = "constant"  # "constant" | "cosine" (warmup ->
    # cosine decay to lr_final_scale * learning_rate over cfg.steps)
    warmup_steps: int = 0  # linear warmup from 0 (schedules only)
    lr_final_scale: float = 0.0  # cosine floor as a fraction of peak lr
    t: float = 0.25  # snapshot time ("fixed") or sampling base
    t_sampling: str = "fixed"  # "fixed" | "uniform" (t ~ U(0,1) per step)
    seed: int = 0
    log_every: int = 10
    use_fused: bool = False  # fused step: the fields come from the kernel
    # pair of pallas/fieldgen.py, whose backward recomputes the [3N, H]
    # hidden activation instead of keeping it in device memory
    precision: str = "f32"  # "f32" | "bf16" — field-generation precision
    # (models/mlp.forward's tiers; the fused step's kernel pair mirrors them)
    remat: bool = False  # rematerialize field generation in the backward
    # (drops the [N, H] hidden-activation residual from HBM; trades ~1
    # forward recompute for memory headroom on large grids)
    matmul_precision: str | None = None  # None (module defaults) |
    # "bfloat16" | "tensorfloat32" | "float32": jax.default_matmul_precision
    # for the whole step. NOTE: the coordinate MLP pins its own matmuls to
    # HIGHEST for the parity doctrine, so this only affects unpinned matmuls
    # (e.g. custom generators); the fast-gradient path for the core model
    # is use_fused.


class TrainState(NamedTuple):
    params: mlp.Params
    opt_state: Any
    step: jnp.ndarray  # scalar int32
    key: jnp.ndarray


def make_schedule(cfg: TrainConfig):
    """Learning-rate schedule per cfg: a float (constant) or an optax
    schedule callable (warmup -> cosine decay over cfg.steps)."""
    if cfg.lr_schedule == "constant":
        if cfg.warmup_steps > 0:
            return optax.linear_schedule(
                0.0, cfg.learning_rate, cfg.warmup_steps
            )
        return cfg.learning_rate
    if cfg.lr_schedule == "cosine":
        return optax.warmup_cosine_decay_schedule(
            init_value=0.0,
            peak_value=cfg.learning_rate,
            warmup_steps=cfg.warmup_steps,
            decay_steps=max(cfg.steps, cfg.warmup_steps + 1),
            end_value=cfg.lr_final_scale * cfg.learning_rate,
        )
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")


def make_optimizer(cfg: TrainConfig) -> optax.GradientTransformation:
    """Optimizer chain: optional global-norm clip -> adam/adamw/sgd under
    the configured schedule. Everything is optax-standard so the state
    checkpoints through train/checkpoint.py unchanged (pure pytrees)."""
    lr = make_schedule(cfg)
    if cfg.optimizer == "adam":
        core = optax.adam(lr)
    elif cfg.optimizer == "adamw":
        core = optax.adamw(lr, weight_decay=cfg.weight_decay)
    elif cfg.optimizer == "sgd":
        core = optax.sgd(lr)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    if cfg.grad_clip > 0.0:
        return optax.chain(optax.clip_by_global_norm(cfg.grad_clip), core)
    return core


def init_state(
    cfg: TrainConfig, mcfg: MLPGridConfig, seed: int | None = None
) -> TrainState:
    seed = cfg.seed if seed is None else seed
    params = mlp.init_params(mcfg.dims, seed=seed)
    opt = make_optimizer(cfg)
    return TrainState(
        params=params,
        opt_state=opt.init(params),
        step=jnp.int32(0),
        # the PRNG stream follows the same seed override as the params, so
        # multi-seed runs are independent in BOTH init and t-sampling
        key=jax.random.PRNGKey(seed),
    )


def loss_fn(
    g: GridSpec,
    w: PhysWeights,
    mcfg: MLPGridConfig,
    params: mlp.Params,
    t,
    use_fused: bool = False,
    remat: bool = False,
    precision: str = "f32",
):
    """Scalar physics loss of the MLP-generated fields at time t.

    use_fused=True generates the fields with the kernel pair
    (pallas/fieldgen.py); `precision` selects the tier of either generator.
    XLA keeps the residual stencil, the loss and their adjoint either
    way."""
    if use_fused:
        from phys_autodiff_tpu.pallas import fieldgen

        fs = fieldgen.generate_fields(g, mcfg, params, t, g.dt, precision)
        return ops.total_loss(g, w, fs)
    gen = lambda p, tt: fields_mod.generate_fields(
        g, mcfg, p, tt, g.dt, precision
    )
    if remat:
        gen = jax.checkpoint(gen)
    fs = gen(params, t)
    return ops.total_loss(g, w, fs)


def make_train_step(
    g: GridSpec, w: PhysWeights, mcfg: MLPGridConfig, cfg: TrainConfig
) -> Callable[[TrainState], tuple[TrainState, jnp.ndarray]]:
    """Returns the jitted (state) -> (state', loss) step."""
    return jax.jit(_make_step_fn(g, w, mcfg, cfg))


def make_train_epoch(
    g: GridSpec,
    w: PhysWeights,
    mcfg: MLPGridConfig,
    cfg: TrainConfig,
    steps_per_call: int,
):
    """Scan-based multi-step trainer: runs `steps_per_call` optimizer steps
    inside ONE jitted program (lax.scan), returning the per-step loss trace.

    This is the production shape of the loop — one dispatch per epoch rather
    than per step — and on dispatch-latency-bound setups it is orders of
    magnitude faster wall-clock than the step-at-a-time loop.
    """
    step = _make_step_fn(g, w, mcfg, cfg)

    @jax.jit
    def epoch(state: TrainState):
        def body(state, _):
            state, loss = step(state)
            return state, loss

        return jax.lax.scan(body, state, None, length=steps_per_call)

    return epoch


def _make_step_fn(g, w, mcfg, cfg):
    """Unjitted single step (shared by make_train_step and make_train_epoch)."""
    opt = make_optimizer(cfg)

    def step(state: TrainState):
        key, sub = jax.random.split(state.key)
        if cfg.t_sampling == "uniform":
            t = jax.random.uniform(sub, ())
        else:
            t = jnp.float32(cfg.t)
        loss, grads = jax.value_and_grad(
            lambda p: loss_fn(
                g, w, mcfg, p, t, cfg.use_fused, cfg.remat, cfg.precision
            )
        )(state.params)
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1, key), loss

    if cfg.matmul_precision is not None:
        inner = step

        def step(state):
            with jax.default_matmul_precision(cfg.matmul_precision):
                return inner(state)

    return step


def fit(
    g: GridSpec,
    w: PhysWeights,
    mcfg: MLPGridConfig,
    cfg: TrainConfig,
    state: TrainState | None = None,
    callback: Callable[[int, float], None] | None = None,
):
    """Run the loop; returns (final_state, history, elapsed_seconds) where
    history is a list of (step, loss) pairs sampled every cfg.log_every
    steps (plus the final step).

    The reference's acceptance criterion (REQUIREMENT.md:164-169): the loss
    should drop >= 90% within the configured number of steps.
    """
    if state is None:
        state = init_state(cfg, mcfg)
    step = make_train_step(g, w, mcfg, cfg)
    history = []
    t0 = time.perf_counter()
    for i in range(cfg.steps):
        state, loss = step(state)
        if i % cfg.log_every == 0 or i == cfg.steps - 1:
            loss_f = float(loss)
            history.append((int(state.step), loss_f))
            if callback:
                callback(int(state.step), loss_f)
    elapsed = time.perf_counter() - t0
    return state, history, elapsed


def fit_scan(
    g: GridSpec,
    w: PhysWeights,
    mcfg: MLPGridConfig,
    cfg: TrainConfig,
    state: TrainState | None = None,
    callback: Callable[[int, float], None] | None = None,
    steps_per_call: int | None = None,
):
    """Like fit(), but runs the loop on-device with lax.scan: one dispatch
    per `steps_per_call` steps (default: log_every). Returns the same
    (state, history, elapsed); history holds one (step, loss) pair per
    chunk — the LAST loss of each scan call, not a per-step trace."""
    if state is None:
        state = init_state(cfg, mcfg)
    chunk = steps_per_call or max(1, cfg.log_every)
    epoch = make_train_epoch(g, w, mcfg, cfg, chunk)
    history = []
    t0 = time.perf_counter()
    done = 0
    while done < cfg.steps:
        # Size the last call to the remainder so exactly cfg.steps optimizer
        # steps run (a second scan program is compiled only when needed).
        this = min(chunk, cfg.steps - done)
        if this != chunk:
            epoch = make_train_epoch(g, w, mcfg, cfg, this)
        state, losses = epoch(state)
        done += this
        loss_f = float(losses[-1])
        history.append((int(state.step), loss_f))
        if callback:
            callback(int(state.step), loss_f)
    elapsed = time.perf_counter() - t0
    return state, history, elapsed


def make_ngp_train_step(
    g: GridSpec,
    w: PhysWeights,
    ncfg,
    cfg: TrainConfig,
    params0: dict,
    precision: str = "f32",
):
    """Training step for the NGP hash-encoded field model: value_and_grad
    through the XLA pipeline (encoder, decode head, stencil and loss).
    precision="bf16" runs the decode-head matmuls with bf16 operands.
    Returns (jitted_step, initial TrainState)."""
    from phys_autodiff_tpu.models import ngp as ngp_mod

    return make_generic_train_step(
        g,
        w,
        lambda p, t: ngp_mod.generate_fields(g, ncfg, p, t, g.dt, precision),
        cfg,
        params0,
    )


def make_generic_train_step(
    g: GridSpec,
    w: PhysWeights,
    generate_fn,
    cfg: TrainConfig,
    params0,
):
    """Model-agnostic training step for any differentiable field generator
    `generate_fn(params, t) -> FieldSnapshots` (plain MLP, NGP hash field,
    ...): jax.value_and_grad of the staged residual loss. Returns
    (jitted_step, initial TrainState)."""
    opt = make_optimizer(cfg)

    def total_loss_of(p, t):
        return ops.total_loss(g, w, generate_fn(p, t))

    def step(state: TrainState):
        key, sub = jax.random.split(state.key)
        if cfg.t_sampling == "uniform":
            t = jax.random.uniform(sub, ())
        else:
            t = jnp.float32(cfg.t)

        loss, grads = jax.value_and_grad(lambda p: total_loss_of(p, t))(state.params)
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1, key), loss

    state0 = TrainState(
        params=params0,
        opt_state=opt.init(params0),
        step=jnp.int32(0),
        key=jax.random.PRNGKey(cfg.seed),
    )
    return jax.jit(step), state0
