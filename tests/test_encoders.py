"""The encoder REGISTRY contract (models/encoders.py): third-party encoder
families plug in via register_family and every downstream consumer — the
decode head, the training step, the sharded step — serves them unchanged.
Pinned by registering a toy PARAMETERIZED family (learned per-channel
gains over Fourier features) and checking the training step's gradients,
including the encoder-parameter pullback through the registry, against
jax.grad and a finite difference. No reference analogue (the reference has
exactly one model family, SURVEY.md §0)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phys_autodiff_tpu import ops
from phys_autodiff_tpu.models import encoders, fourier, ngp
from phys_autodiff_tpu.models.encoders import EncoderFamily, register_family
from phys_autodiff_tpu.models.fourier import FourierEncodingConfig
from phys_autodiff_tpu.utils.config import GridSpec, PhysWeights


@dataclasses.dataclass(frozen=True)
class GainedFourierConfig:
    """Toy third family: Fourier features with a LEARNED per-channel gain —
    the smallest encoder with parameters that is not a built-in, so its
    gradient must flow through the registry's encode_grid pullback."""

    base: FourierEncodingConfig = FourierEncodingConfig(num_frequencies=2)

    @property
    def out_dim(self) -> int:
        return self.base.out_dim


def _gf_init(cfg, seed):
    rng = np.random.Generator(np.random.MT19937(seed + 11))
    return jnp.asarray(
        1.0 + 0.2 * rng.standard_normal(cfg.out_dim), jnp.float32
    )


register_family(
    GainedFourierConfig,
    EncoderFamily(
        name="gained_fourier",
        init_params=_gf_init,
        schedule_meta=lambda cfg: {
            "toy_gained_fourier_k": cfg.base.num_frequencies
        },
        encode=lambda cfg, p, coords: (
            fourier.encode(cfg.base, coords) * p
        ),
        encode_grid=lambda cfg, p, g: fourier.encode_grid(cfg.base, g) * p,
    ),
)

ENC = GainedFourierConfig()


def _setup(nx=128, ny=8, nz=6, periodic=True, scheme="central"):
    g = GridSpec(nx=nx, ny=ny, nz=nz, hx=0.3, hy=0.3, hz=0.3, dt=1e-2,
                 periodic=periodic, scheme=scheme)
    ncfg = ngp.NGPFieldConfig(encoding=ENC, hidden=16)
    params = ngp.init_ngp_params(ncfg, seed=7)
    rng = np.random.Generator(np.random.MT19937(21))
    params["b1"] = jnp.asarray(
        rng.standard_normal(params["b1"].shape) * 0.3, jnp.float32
    )
    params["b2"] = jnp.asarray(
        rng.standard_normal(params["b2"].shape) * 0.3, jnp.float32
    )
    w = PhysWeights(w_sigma=1.3, w_u=0.7)
    return g, w, ncfg, params


def _staged_total(g, w, ncfg, params, t):
    fs = ngp.generate_fields(g, ncfg, params, t, g.dt)
    ls, lu = ops.loss_forward(g, w, fs)
    return ls + lu


def _leaf_close(a, b, tol):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) <= tol * max(np.linalg.norm(a), 1e-30)


def test_registry_contract():
    """Registration guards: conflicting re-registration, missing out_dim,
    unknown config type; same-name re-registration is idempotent."""
    fam = encoders.family_of(ENC)
    assert fam.name == "gained_fourier"
    register_family(GainedFourierConfig, fam)  # idempotent
    with pytest.raises(ValueError):
        register_family(
            GainedFourierConfig, dataclasses.replace(fam, name="other")
        )

    class NoOutDim:
        pass

    with pytest.raises(TypeError):
        register_family(NoOutDim, fam)
    with pytest.raises(TypeError):
        encoders.family_of(object())
    with pytest.raises(TypeError):
        register_family("not-a-type", fam)


def test_dispatch_routes_toy_family():
    g, _, _, _ = _setup(nx=12, ny=7, nz=5)
    p = encoders.init_params(ENC, seed=3)
    assert p.shape == (ENC.out_dim,)
    grid = np.asarray(encoders.encode_grid(ENC, p, g))
    ref = np.asarray(fourier.encode_grid(ENC.base, g)) * np.asarray(p)
    np.testing.assert_array_equal(grid, ref)
    pts = ngp._unit_coords(g)
    np.testing.assert_array_equal(
        np.asarray(encoders.encode(ENC, p, pts)), grid)
    meta = encoders.schedule_meta(ENC)
    assert meta == {"toy_gained_fourier_k": 2}
    assert meta != encoders.schedule_meta(ENC.base)


@pytest.mark.parametrize("family", ["hash", "fourier"])
def test_dispatch_routes_builtin_families(family):
    """The registry's four callables are the family modules' own."""
    from phys_autodiff_tpu.models import hash_encoder
    from phys_autodiff_tpu.models.hash_encoder import HashEncodingConfig

    g, _, _, _ = _setup(nx=12, ny=7, nz=5)
    pts = ngp._unit_coords(g)
    if family == "hash":
        cfg = HashEncodingConfig(num_levels=3, base_resolution=3,
                                 max_resolution=10, log2_table_size=5,
                                 dense_oversubscribed=True)
        p = encoders.init_params(cfg, seed=1)
        grid = hash_encoder.encode_grid(cfg, p, g)
        point = hash_encoder.encode(cfg, p, pts)
    else:
        cfg = ENC.base
        p = encoders.init_params(cfg, seed=1)
        grid = fourier.encode_grid(cfg, g)
        point = fourier.encode(cfg, pts)
    np.testing.assert_array_equal(
        np.asarray(encoders.encode_grid(cfg, p, g)), np.asarray(grid))
    np.testing.assert_array_equal(
        np.asarray(encoders.encode(cfg, p, pts)), np.asarray(point))
    assert encoders.out_dim(cfg) == grid.shape[-1]


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "clamp"])
def test_toy_family_train_grad_matches_staged_grad(periodic):
    """The jitted training gradient serves a REGISTERED family: loss, head
    grads and the encoder-parameter gradient through the registry's
    regular-grid encoder equal jax.grad through its pointwise encoder (two
    independent code paths of the family, assembled into the same
    snapshots)."""
    g, w, ncfg, params = _setup(nx=24, periodic=periodic)
    t = jnp.float32(0.3)

    def pointwise_total(p):
        coords = ngp._unit_coords(g)
        ys = [ngp.forward(ncfg, p, coords, tt)
              for tt in (t - jnp.float32(g.dt), t, t + jnp.float32(g.dt))]
        fs = ops.FieldSnapshots(
            *[y[..., 0] for y in ys],
            *[jnp.moveaxis(y[..., 1:4], -1, 0) for y in ys],
        )
        ls, lu = ops.loss_forward(g, w, fs)
        return ls + lu

    loss_ref, g_ref = jax.value_and_grad(pointwise_total)(params)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: _staged_total(g, w, ncfg, p, t)))(params)
    assert abs(float(loss) - float(loss_ref)) <= 1e-5 * abs(float(loss_ref))
    assert float(jnp.sum(jnp.abs(grads["tables"]))) > 0.0
    tol = 1e-4 if periodic else 5e-3
    for k in ("tables", "W1", "b1", "W2", "b2"):
        assert _leaf_close(g_ref[k], grads[k], tol), k


def test_toy_family_sharded_matches_single():
    """The sharded generic step serves the registered family: the first
    step's loss on an 8-device mesh matches the single-device train step,
    and training on the mesh lowers the loss."""
    from phys_autodiff_tpu.parallel.mesh import make_mesh
    from phys_autodiff_tpu.parallel.sharded import (
        make_generic_sharded_train_step,
    )
    from phys_autodiff_tpu.train import loop as train_loop

    assert len(jax.devices()) >= 8
    mesh = make_mesh(8)
    g, w, ncfg, params = _setup(nx=24, nz=16)
    t = jnp.float32(0.3)
    cfg = train_loop.TrainConfig(t=0.3, learning_rate=1e-3)
    step1, st1 = train_loop.make_ngp_train_step(g, w, ncfg, cfg, params)
    _, l1 = step1(st1)
    step_n, init_n = make_generic_sharded_train_step(
        g, w, lambda p, tt: ngp.generate_fields(g, ncfg, p, tt, g.dt), mesh,
        ngp.init_ngp_params(ncfg, seed=7) | {
            k: params[k] for k in ("b1", "b2")},
    )
    pn, on = init_n()
    losses = []
    for _ in range(3):
        pn, on, ln = step_n(pn, on, t)
        losses.append(float(ln))
    assert abs(losses[0] - float(l1)) <= 5e-6 * abs(float(l1))
    assert losses[-1] < losses[0]
