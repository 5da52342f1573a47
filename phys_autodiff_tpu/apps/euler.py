"""Incompressible Euler "smoke" solver — advect / force / project.

The downstream workload the reference's plan gestures at ("more realistic
smoke velocity fields", reference: docs/PLAN_MLP_SMOKE_INTEGRATION.md:51)
but never built: a stable fluid stepper in the Stam tradition, assembled
entirely from framework primitives —

  1. self-advect velocity     apps.transport's gather-free semi-Lagrangian
                              step applied per component (CFL <= 1),
  2. apply body forces        buoyancy `b * sigma * z_hat` on the smoke
                              density itself,
  3. diffuse (optional)       ops.diffusion implicit viscosity /
                              scalar diffusivity — unconditionally
                              stable FFT (periodic) or CG (clamp),
  4. project                  ops.projection (exact FFT on periodic boxes,
                              CGNR under clamp) so the discrete
                              divergence the residual operator sees is
                              driven to ~0,
  5. advect the density       through the projected velocity.

Everything is jnp under one jit; rollouts are a single lax.scan (no
data-dependent Python control flow); the semi-Lagrangian interpolation is
monotone, so sigma obeys the discrete max principle step over step.

This is an application ON the framework, not parity surface: the reference
never advances state in time (SURVEY.md §0 "no integrator"). It exists so
a trained field model — or any initial condition — can be rolled out as an
actual incompressible flow, and it exercises projection + transport +
diagnostics together.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from phys_autodiff_tpu.apps.transport import max_cfl
from phys_autodiff_tpu.ops import diagnostics, diffusion, projection
from phys_autodiff_tpu.ops.stencil import inv2h_f32
from phys_autodiff_tpu.utils.config import GridSpec


@dataclasses.dataclass(frozen=True)
class EulerConfig:
    dt: float = 1e-3
    steps: int = 1
    buoyancy: float = 0.0  # force = buoyancy * sigma along +z
    viscosity: float = 0.0  # implicit momentum diffusion (ops.diffusion)
    diffusivity: float = 0.0  # implicit density diffusion
    projection: str = "auto"  # "auto" | "fft" | "cg" | "none"
    cg_maxiter: int = 200
    cg_tol: float = 1e-6
    advection: str = "semi_lagrangian"  # "semi_lagrangian" | "maccormack"
    # (second-order limited MacCormack, apps.transport.maccormack_step)
    confinement: float = 0.0  # vorticity-confinement strength epsilon
    # (force = eps * h * N x omega, Fedkiw/Stam/Jensen 2001) — restores
    # the small-scale swirl the semi-Lagrangian lerp dissipates
    remat: bool = False  # rematerialize each step in backward passes:
    # jax.grad through the rollout normally stores EVERY intermediate of
    # every step (tens of grid-sized arrays/step — advection offsets,
    # MacCormack fwd/bwd fields, FFT spectra), capping the differentiable
    # horizon at a few steps on one chip at real grids. remat=True wraps
    # the step in jax.checkpoint, so the backward stores only the carried
    # (sigma, u) per step and recomputes the step's interior on the way
    # back — the classic HBM-for-FLOPs trade (forward values and gradients
    # are unchanged; forward-only rollouts are unaffected either way)


class EulerState(NamedTuple):
    sigma: jnp.ndarray  # [nz, ny, nx]
    u: jnp.ndarray  # [3, nz, ny, nx]


class EulerSource(NamedTuple):
    """Continuous sources for the smoke solver (the classic
    emitter + fan): per-step smoke injection d sigma/dt = sigma_rate
    [nz, ny, nx] and a momentum body force f [3, nz, ny, nx] (both may
    be zero arrays; build region-shaped fields with the ops.obstacles
    mask helpers: rate * complement(box_mask(...))). A plain pytree, so
    it shards, scans, and differentiates like the state itself."""

    sigma_rate: jnp.ndarray  # [nz, ny, nx] smoke injected per unit time
    force: jnp.ndarray  # [3, nz, ny, nx] momentum force (pre-projection)

    @staticmethod
    def zeros(g: GridSpec) -> "EulerSource":
        return EulerSource(
            jnp.zeros(g.shape, jnp.float32),
            jnp.zeros((3,) + g.shape, jnp.float32),
        )


def _project(
    g: GridSpec, u: jnp.ndarray, cfg: EulerConfig, mask=None
) -> jnp.ndarray:
    mode = cfg.projection
    if mask is not None and mode != "none":
        # obstacles have no fast diagonalization; always the masked CGNR
        # solve (ops.obstacles.project_masked), either boundary mode
        from phys_autodiff_tpu.ops import obstacles

        return obstacles.project_masked(
            g, u, mask, maxiter=cfg.cg_maxiter, tol=cfg.cg_tol
        )
    if mode == "auto":
        mode = "fft" if g.periodic else "cg"
    if mode == "fft":
        return projection.project_fft(g, u)
    if mode == "cg":
        return projection.project_cg(
            g, u, maxiter=cfg.cg_maxiter, tol=cfg.cg_tol
        )
    if mode == "none":
        return u
    raise ValueError(f"unknown projection mode {cfg.projection!r}")


def vorticity_confinement(
    g: GridSpec, u: jnp.ndarray, eps: float
) -> jnp.ndarray:
    """Vorticity-confinement body force f = eps * h * (N x omega)
    (Fedkiw, Stam, Jensen, "Visual Simulation of Smoke", 2001):
    omega = curl u, N = normalized grad |omega| points toward vortex
    cores, so the force spins energy back into the swirls the
    semi-Lagrangian lerp dissipates. h is the geometric-mean cell size
    (the classical scalar h, generalized for anisotropic grids); built
    entirely from the residual stencil's central differences, so the
    boundary topology matches the rest of the framework. Returns
    [3, nz, ny, nx]; identically zero for irrotational fields."""
    w = diagnostics.curl(g, u)
    # sqrt(s + tiny): d/ds sqrt(s) is infinite at s=0 and would poison
    # gradients THROUGH the rollout (the solver is differentiable and
    # used that way — see fit_initial_velocity); the 1e-30 floor changes
    # wmag by <= 1e-15 absolute and keeps the force identically zero for
    # irrotational fields (w = 0 factors out of N x w)
    wmag = jnp.sqrt(jnp.sum(w * w, axis=0) + jnp.float32(1e-30))
    eta = projection.grad(g, wmag)
    n = eta / (jnp.sqrt(jnp.sum(eta * eta, axis=0)) + jnp.float32(1e-20))
    h = float((g.hx * g.hy * g.hz) ** (1.0 / 3.0))
    s = jnp.float32(eps * h)
    return s * jnp.stack([
        n[1] * w[2] - n[2] * w[1],
        n[2] * w[0] - n[0] * w[2],
        n[0] * w[1] - n[1] * w[0],
    ])


def _advect(g: GridSpec, cfg: EulerConfig):
    from phys_autodiff_tpu.apps.transport import TransportConfig, make_step

    return make_step(g, TransportConfig(scheme=cfg.advection))


def _advect_many(g: GridSpec, cfg: EulerConfig):
    """Batched multi-scalar advection for the velocity self-advection:
    one pass over [3, nz, ny, nx] with shared offsets — bitwise equal to
    three single-component steps (see transport.transport_step_many for
    why batching fuses better). Scheme dispatch lives
    in transport.make_step_many (one home for all flavors)."""
    from phys_autodiff_tpu.apps.transport import TransportConfig, make_step_many

    return make_step_many(g, TransportConfig(scheme=cfg.advection))


def euler_step(
    g: GridSpec,
    state: EulerState,
    cfg: EulerConfig,
    *,
    mask=None,
    source: EulerSource | None = None,
) -> EulerState:
    """One advect/force/project step. Velocity self-advection uses the
    pre-step velocity for the backtrace (standard semi-Lagrangian
    linearization); the density advects through the POST-projection
    velocity so it is transported by a divergence-free field.

    `mask` (optional [nz, ny, nx] fluid mask, 1 = fluid, 0 = solid —
    ops.obstacles) adds internal solid boundaries: every stage's output
    is re-masked (no-slip; exact fixed point for semi-Lagrangian
    advection, enforcement for MacCormack's corrector and the implicit
    diffusion resolvent, which are solved obstacle-blind — first-order
    splitting), forces act on fluid cells only, and the projection is
    the masked CGNR solve. The smoke density is also zeroed in solids
    (it can never be transported in: the advecting velocity is zero
    there).

    `source` (optional EulerSource) adds continuous emitters: the
    momentum force joins the other body forces (pre-projection, so
    injected divergence is removed like buoyancy's), and the smoke
    injection sigma += dt * sigma_rate lands AFTER the density
    transport (forward-Euler source splitting) — with zero velocity an
    emitter therefore grows exactly linearly, the oracle the tests pin.
    Sources in solid cells are ignored (masked)."""
    sigma, u = state
    dt = jnp.float32(cfg.dt)
    advect = _advect(g, cfg)
    if mask is not None:
        from phys_autodiff_tpu.ops.obstacles import apply_no_slip

        u = apply_no_slip(u, mask)
        # Mask the incoming density too: an initial sigma nonzero inside a
        # solid would otherwise be advected into adjacent fluid cells on
        # the first step, breaking the "solid cells stay exactly zero"
        # invariant for rollout/rollout_loss callers that (unlike the CLI)
        # did not pre-mask their initial state.
        sigma = apply_no_slip(sigma, mask)
    # 1. self-advection through the frozen pre-step u — all 3 components
    #    in ONE batched pass (shared offsets; bitwise equal to
    #    component-wise)
    u_adv = _advect_many(g, cfg)(u, u, cfg.dt)
    if mask is not None:
        u_adv = apply_no_slip(u_adv, mask)
    # 2. body forces: buoyancy (smoke density pushes +z) + vorticity
    #    confinement (computed from the post-advection velocity, the
    #    standard stage order — both are pre-projection, so the
    #    projection removes any divergence they inject)
    if cfg.buoyancy != 0.0:
        fz = jnp.float32(cfg.buoyancy) * sigma
        if mask is not None:
            fz = fz * mask
        u_adv = u_adv.at[2].add(dt * fz)
    if cfg.confinement != 0.0:
        conf = vorticity_confinement(g, u_adv, cfg.confinement)
        if mask is not None:
            from phys_autodiff_tpu.ops.obstacles import apply_no_slip

            conf = apply_no_slip(conf, mask)
        u_adv = u_adv + dt * conf
    if source is not None:
        f = source.force
        if mask is not None:
            f = f * mask[None]
        u_adv = u_adv + dt * f
    # 3. implicit viscosity (Stam order: diffuse, then project so the
    #    field the density sees is solenoidal; on periodic grids the
    #    compact Laplacian commutes with div, so the order is moot there)
    if cfg.viscosity != 0.0:
        u_adv = diffusion.diffuse(g, u_adv, cfg.viscosity, cfg.dt)
        if mask is not None:
            u_adv = apply_no_slip(u_adv, mask)
    # 4. pressure projection (masked CGNR when obstacles are present)
    u_new = _project(g, u_adv, cfg, mask)
    # 5. density transport through the divergence-free field, then
    #    implicit scalar diffusion (both stages preserve the max principle:
    #    monotone interpolation / M-matrix resolvent; the limited
    #    MacCormack scheme is clamped into the neighbor-ring bounds, so
    #    the principle holds for it too)
    sigma_new = advect(sigma, u_new, cfg.dt)
    if source is not None:
        rate = source.sigma_rate
        if mask is not None:
            rate = rate * mask
        sigma_new = sigma_new + dt * rate
    if cfg.diffusivity != 0.0:
        sigma_new = diffusion.diffuse(g, sigma_new, cfg.diffusivity, cfg.dt)
    if mask is not None:
        sigma_new = sigma_new * mask
    return EulerState(sigma_new, u_new)


def rollout(
    g: GridSpec,
    state0: EulerState,
    cfg: EulerConfig,
    *,
    mask=None,
    source: EulerSource | None = None,
):
    """cfg.steps Euler steps as one lax.scan (call under jit).

    Returns (final EulerState, per-step diagnostics dict of arrays
    [steps]: max_cfl, max |div u|, mean kinetic energy).

    With cfg.remat the step is checkpointed: differentiating through the
    rollout then stores one (sigma, u) pair per step instead of every
    interior intermediate (see EulerConfig.remat — measured on hardware,
    scripts/euler_bench.py --remat).

    `mask` adds solid obstacles (see euler_step); the max_abs_div
    diagnostic then reports only INTERIOR fluid cells (the boundary
    layer sees the solid through the wide stencil and is excluded —
    ops.obstacles.fluid_divergence). `source` adds continuous
    emitters/forces (EulerSource), applied every step."""
    step_fn = lambda s: euler_step(g, s, cfg, mask=mask, source=source)
    if mask is None:
        div_of = lambda u: projection.projection_residual(g, u)
    else:
        from phys_autodiff_tpu.ops.obstacles import fluid_divergence

        div_of = lambda u: fluid_divergence(g, u, mask)
    if cfg.remat:
        step_fn = jax.checkpoint(step_fn)

    def body(state, _):
        new = step_fn(state)
        diag = (
            max_cfl(g, new.u, cfg.dt),
            div_of(new.u),
            diagnostics.kinetic_energy(new.u),
        )
        return new, diag

    final, (cfls, divs, kes) = jax.lax.scan(
        body, state0, None, length=cfg.steps
    )
    return final, {"max_cfl": cfls, "max_abs_div": divs, "kinetic_energy": kes}


def rollout_sharded(
    g: GridSpec, state0: EulerState, cfg: EulerConfig, mesh
):
    """Multi-chip Euler rollout: state z-sharded over the mesh, every stage
    expressed shard-local with explicit collectives —

      * advection: make_shard_local_step — semi-Lagrangian or limited
        MacCormack per cfg.advection (2-plane ppermute z halos),
      * vorticity confinement: shard-local curl/grad with z halo diffs,
      * projection: the pencil-decomposed distributed FFT
        (parallel.spectral — two all_to_all transposes per solve),
      * viscosity/diffusivity: pencil-decomposed implicit diffusion,
      * diagnostics: pmax/psum reductions.

    Periodic boundaries + FFT projection only (the clamp/CG path is
    single-chip; assert early). Same stage order as `euler_step`; parity
    vs the single-chip rollout is fp-tolerance (the pencil FFT evaluates
    in a different order than the fused rfftn). Returns the final
    EulerState (z-sharded) and the same diagnostics dict as `rollout`."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from phys_autodiff_tpu.apps.transport import (
        TransportConfig,
        make_shard_local_step,
        make_shard_local_step_many,
    )
    from phys_autodiff_tpu.parallel.mesh import Z_AXIS
    from phys_autodiff_tpu.parallel.spectral import (
        _halo_zdiff,
        _local_xydiff,
        shard_local_diffuse_fft,
        shard_local_project_fft,
    )

    assert g.periodic, "rollout_sharded requires periodic boundaries"
    assert cfg.projection in ("auto", "fft"), cfg.projection
    n = mesh.shape[Z_AXIS]
    assert g.nz % n == 0 and g.ny % n == 0, (g.shape, n)

    tcfg = TransportConfig(scheme=cfg.advection)
    tstep = make_shard_local_step(g, tcfg)
    tstep_many = make_shard_local_step_many(g, tcfg)
    project = shard_local_project_fft(g, n)
    diffuse_u = (
        shard_local_diffuse_fft(g, n, cfg.viscosity, cfg.dt)
        if cfg.viscosity != 0.0 else None
    )
    diffuse_s = (
        shard_local_diffuse_fft(g, n, cfg.diffusivity, cfg.dt)
        if cfg.diffusivity != 0.0 else None
    )
    n_cells = float(g.num_cells)

    def local_div(ul):
        return (
            _local_xydiff(ul[0], 2, inv2h_f32(g.hx))
            + _local_xydiff(ul[1], 1, inv2h_f32(g.hy))
            + _halo_zdiff(ul[2], inv2h_f32(g.hz))
        )

    def local_confinement(ul):
        # shard-local curl / grad|w|: x/y diffs are local, z diffs ride
        # the 2-plane ppermute halo — same arithmetic per cell as the
        # single-chip vorticity_confinement (periodic precondition holds).
        # The ux/uy z-diffs share ONE batched halo exchange (axis=1), so
        # the stage costs 2 exchange rounds, not 3.
        from phys_autodiff_tpu.parallel.sharded import _halo_extend_z

        ext01 = _halo_extend_z(ul[:2], True, axis=1)
        inv2hz = inv2h_f32(g.hz)
        dz_ux = (ext01[0, 2:] - ext01[0, :-2]) * inv2hz
        dz_uy = (ext01[1, 2:] - ext01[1, :-2]) * inv2hz
        wx = _local_xydiff(ul[2], 1, inv2h_f32(g.hy)) - dz_uy
        wy = dz_ux - _local_xydiff(ul[2], 2, inv2h_f32(g.hx))
        wz = _local_xydiff(ul[1], 2, inv2h_f32(g.hx)) - _local_xydiff(
            ul[0], 1, inv2h_f32(g.hy))
        # same AD-safe sqrt floor as vorticity_confinement (identical
        # per-cell arithmetic keeps the sharded==single parity)
        wmag = jnp.sqrt(wx * wx + wy * wy + wz * wz + jnp.float32(1e-30))
        ex = _local_xydiff(wmag, 2, inv2h_f32(g.hx))
        ey = _local_xydiff(wmag, 1, inv2h_f32(g.hy))
        ez = _halo_zdiff(wmag, inv2h_f32(g.hz))
        inv = 1.0 / (jnp.sqrt(ex * ex + ey * ey + ez * ez)
                     + jnp.float32(1e-20))
        nx_, ny_, nz_ = ex * inv, ey * inv, ez * inv
        s = jnp.float32(
            cfg.confinement * float((g.hx * g.hy * g.hz) ** (1.0 / 3.0)))
        return s * jnp.stack([
            ny_ * wz - nz_ * wy,
            nz_ * wx - nx_ * wz,
            nx_ * wy - ny_ * wx,
        ])

    def local_step(state):
        sigma, u = state
        dt = jnp.float32(cfg.dt)
        # batched self-advection (one pass over [3, ...], shared offsets —
        # bitwise equal to component-wise, ~4x faster single-chip)
        u_adv = tstep_many(u, u, cfg.dt)
        if cfg.buoyancy != 0.0:
            u_adv = u_adv.at[2].add(dt * jnp.float32(cfg.buoyancy) * sigma)
        if cfg.confinement != 0.0:
            u_adv = u_adv + dt * local_confinement(u_adv)
        if diffuse_u is not None:
            u_adv = diffuse_u(u_adv)
        u_new = project(u_adv)
        sigma_new = tstep(sigma, u_new, cfg.dt)
        if diffuse_s is not None:
            sigma_new = diffuse_s(sigma_new)
        return EulerState(sigma_new, u_new)

    local_step_fn = (
        jax.checkpoint(local_step) if cfg.remat else local_step
    )

    def local_roll(sigma_l, u_l):
        def body(state, _):
            new = local_step_fn(state)
            cfl = jax.lax.pmax(
                jnp.max(jnp.stack([
                    jnp.max(jnp.abs(new.u[0])) * jnp.float32(cfg.dt) / g.hx,
                    jnp.max(jnp.abs(new.u[1])) * jnp.float32(cfg.dt) / g.hy,
                    jnp.max(jnp.abs(new.u[2])) * jnp.float32(cfg.dt) / g.hz,
                ])), Z_AXIS)
            dmax = jax.lax.pmax(
                jnp.max(jnp.abs(local_div(new.u))), Z_AXIS)
            ke = jax.lax.psum(
                0.5 * jnp.sum(new.u * new.u), Z_AXIS) / n_cells
            return new, (cfl, dmax, ke)

        final, diags = jax.lax.scan(
            body, EulerState(sigma_l, u_l), None, length=cfg.steps
        )
        return final.sigma, final.u, diags

    rolled = jax.shard_map(
        local_roll,
        mesh=mesh,
        in_specs=(P(Z_AXIS), P(None, Z_AXIS)),
        out_specs=(P(Z_AXIS), P(None, Z_AXIS), (P(), P(), P())),
        check_vma=False,
    )
    sigma0 = jax.device_put(
        state0.sigma, NamedSharding(mesh, P(Z_AXIS)))
    u0 = jax.device_put(state0.u, NamedSharding(mesh, P(None, Z_AXIS)))
    sig, u, (cfls, divs, kes) = jax.jit(rolled)(sigma0, u0)
    return EulerState(sig, u), {
        "max_cfl": cfls, "max_abs_div": divs, "kinetic_energy": kes,
    }


def rollout_loss(
    g: GridSpec,
    u0: jnp.ndarray,
    sigma0: jnp.ndarray,
    target_sigma: jnp.ndarray,
    cfg: EulerConfig,
    *,
    mask=None,
    source: EulerSource | None = None,
) -> jnp.ndarray:
    """MSE between the density after a cfg.steps rollout from (sigma0, u0)
    and target_sigma — THE differentiable-simulation objective: every
    stage of the solver (semi-Lagrangian/MacCormack selects, ring-bounds
    clamps, confinement, FFT projection, implicit diffusion) is plain jnp
    under lax.scan, so jax.grad of this function is the exact discrete
    adjoint of the whole rollout. u0 passes through the cfg's projection
    first, so under any projecting mode the search space is the solenoidal
    subspace the dynamics live in (with cfg.projection == "none" the
    rollout itself is unprojected and u0 is taken as-is). With a fluid
    `mask` the whole chain is obstacle-aware (masks are multiplies, so
    the adjoint passes through them exactly). `source` is a
    differentiable argument too — close over a parameterized
    EulerSource and jax.grad w.r.t. the emitter/force field to solve
    source-control problems."""
    u0 = _project(g, u0, cfg, mask)
    final, _ = rollout(g, EulerState(sigma0, u0), cfg, mask=mask,
                       source=source)
    d = final.sigma - target_sigma
    return jnp.mean(d * d)


def fit_initial_velocity(
    g: GridSpec,
    sigma0: jnp.ndarray,
    target_sigma: jnp.ndarray,
    cfg: EulerConfig,
    *,
    u0_init: jnp.ndarray | None = None,
    opt_steps: int = 50,
    learning_rate: float = 0.5,
    mask=None,
    source: EulerSource | None = None,
):
    """Inverse problem / control: find the initial velocity whose
    cfg.steps-step rollout carries sigma0 to target_sigma, by Adam on
    jax.grad THROUGH the solver (the capability the framework's name
    promises, applied to its own application layer — the reference has
    no integrator, let alone its adjoint).

    Whole optimization runs on-device as one jitted lax.scan over
    optimizer steps. For long horizons set cfg.remat: the adjoint then
    stores one state per rollout step instead of every interior
    intermediate, which is the difference between a ~6-step and a
    100+-step differentiable horizon at real grids on one chip.
    Returns (u0_opt [3, nz, ny, nx], losses [opt_steps]);
    u0_opt passes through cfg's projection, so it is divergence-free under
    any projecting mode — with cfg.projection == "none" it is the raw Adam
    iterate (the unprojected dynamics the config asked for). `mask` and
    `source` pass through to rollout_loss, so emitter-past-an-obstacle
    inverse problems run through this convenience fitter unchanged."""
    import optax

    if u0_init is None:
        u0_init = jnp.zeros((3,) + g.shape, jnp.float32)
    opt = optax.adam(learning_rate)

    loss_of = lambda u0: rollout_loss(
        g, u0, sigma0, target_sigma, cfg, mask=mask, source=source)

    @jax.jit
    def solve(u0):
        def body(carry, _):
            u, opt_state = carry
            loss, grad = jax.value_and_grad(loss_of)(u)
            updates, opt_state = opt.update(grad, opt_state, u)
            return (optax.apply_updates(u, updates), opt_state), loss

        (u, _), losses = jax.lax.scan(
            body, (u0, opt.init(u0)), None, length=opt_steps)
        return _project(g, u, cfg, mask), losses

    return solve(u0_init)


def initial_state_from_model(
    g: GridSpec, model_cfg, params, t: float, *, project: bool = True
) -> EulerState:
    """Seed the solver from a trained field model snapshot at time t
    (MLP or any registered encoder family), optionally projecting the
    model's velocity onto the divergence-free subspace first."""
    from phys_autodiff_tpu.models.sample import grid_infer_any

    y = grid_infer_any(g, model_cfg, params, t)
    sigma = y[..., 0]
    u = jnp.moveaxis(y[..., 1:4], -1, 0)
    if project:
        u = projection.project(g, u)
    return EulerState(sigma, u)
