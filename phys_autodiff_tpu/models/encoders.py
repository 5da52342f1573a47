"""Encoder registry: one interface over the encoded-field families.

The encoded-field model (models/ngp.py: encoding -> 2-layer decode head ->
[sigma, ux, uy, uz]) and everything built on it — the training step, the
sharded step, checkpoint metadata — only consume an [..., out_dim]
encoding. This module is the one
place that maps a config TYPE to its implementation. Built-in families:

  * HashEncodingConfig  (models/hash_encoder.py): multiresolution hash /
    dense corner-lattice tables, parameters = the tables.
  * FourierEncodingConfig (models/fourier.py): axis-separable positional
    features, no parameters (empty "tables" leaf keeps the pytree uniform).

Third-party encoders plug in through `register_family`: provide the four
callables below for your frozen-dataclass config type and every downstream
consumer (`NGPFieldConfig(encoding=...)`, the training and sharded steps,
checkpointing) serves it unchanged — `encode_grid` must be
jax-differentiable in the family's parameters. No reference analogue (the
reference has exactly one model family — SURVEY.md §0); this is the
framework-generality surface extensions plug into. tests/test_encoders.py
pins the contract by registering a toy family and training it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from phys_autodiff_tpu.models import fourier as _fourier
from phys_autodiff_tpu.models import hash_encoder as _hash
from phys_autodiff_tpu.models.fourier import FourierEncodingConfig
from phys_autodiff_tpu.models.hash_encoder import HashEncodingConfig

__all__ = [
    "HashEncodingConfig",
    "FourierEncodingConfig",
    "EncoderFamily",
    "register_family",
    "family_of",
    "out_dim",
    "init_params",
    "schedule_meta",
    "encode",
    "encode_grid",
]


@dataclasses.dataclass(frozen=True)
class EncoderFamily:
    """The per-family implementation table. All callables take the config
    first and the family's parameter pytree second (parameter-free families
    simply ignore it), so the dispatch functions below have one uniform
    calling convention:

      init_params(cfg, seed) -> params pytree (the model's "tables" leaf;
        return an EMPTY array, not None, for parameter-free families so the
        encoded-field params pytree keeps its uniform structure)
      schedule_meta(cfg) -> dict of checkpoint-fingerprint entries (restore
        under a different schedule decodes different fields; keep keys
        family-unique so cross-family restores are detected)
      encode(cfg, params, coords) -> [..., out_dim]
        pointwise features for coords [..., 3] in [0, 1]
      encode_grid(cfg, params, g) -> [nz, ny, nx, out_dim]
    """

    name: str
    init_params: Callable[[Any, int], Any]
    schedule_meta: Callable[[Any], dict]
    encode: Callable[..., Any]
    encode_grid: Callable[[Any, Any, Any], Any]


_REGISTRY: dict[type, EncoderFamily] = {}


def register_family(cfg_type: type, family: EncoderFamily) -> None:
    """Register an encoder family for a config type. The config type should
    be a frozen dataclass exposing `out_dim` (an int property is fine)."""
    if not isinstance(cfg_type, type):
        raise TypeError(f"cfg_type must be a type, got {cfg_type!r}")
    prior = _REGISTRY.get(cfg_type)
    if prior is not None and prior.name != family.name:
        raise ValueError(
            f"{cfg_type.__name__} already registered as {prior.name!r}"
        )
    if not hasattr(cfg_type, "out_dim"):
        raise TypeError(f"{cfg_type.__name__} must expose out_dim")
    _REGISTRY[cfg_type] = family


def registered_families() -> list[type]:
    """The registered encoder-config types (ordered by registration)."""
    return list(_REGISTRY)


def family_of(cfg) -> EncoderFamily:
    fam = _REGISTRY.get(type(cfg))
    if fam is None:
        # subclass fallback (exact-type hit is the normal path)
        for t, f in _REGISTRY.items():
            if isinstance(cfg, t):
                return f
        raise TypeError(
            f"unknown encoding config type: {type(cfg)!r} "
            f"(known: {[t.__name__ for t in _REGISTRY]}; see register_family)"
        )
    return fam


def out_dim(cfg) -> int:
    family_of(cfg)
    return cfg.out_dim


def init_params(cfg, seed: int = 0):
    return family_of(cfg).init_params(cfg, seed)


def schedule_meta(cfg) -> dict:
    return family_of(cfg).schedule_meta(cfg)


def encode(cfg, params, coords):
    """Pointwise: coords [..., 3] in [0,1] -> [..., out_dim]."""
    return family_of(cfg).encode(cfg, params, coords)


def encode_grid(cfg, params, g):
    """Regular grid -> [nz, ny, nx, out_dim] (channels-last)."""
    return family_of(cfg).encode_grid(cfg, params, g)


register_family(
    HashEncodingConfig,
    EncoderFamily(
        name="hash",
        init_params=lambda cfg, seed: _hash.init_hash_params(cfg, seed=seed),
        schedule_meta=_hash.schedule_meta,
        encode=_hash.encode,
        encode_grid=_hash.encode_grid,
    ),
)

register_family(
    FourierEncodingConfig,
    EncoderFamily(
        name="fourier",
        init_params=lambda cfg, seed: _fourier.init_params(cfg, seed=seed),
        schedule_meta=_fourier.schedule_meta,
        encode=lambda cfg, params, coords: _fourier.encode(
            cfg, coords
        ),
        encode_grid=lambda cfg, params, g: _fourier.encode_grid(cfg, g),
    ),
)
