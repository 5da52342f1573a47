"""Smoke test of the system on an NVIDIA GPU: the quickest proof that it
still starts, trains and agrees with its references on the card.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded phase only

Phases, in order; the first that fails ends the run with a non-zero exit
code:

  device    JAX must run on a GPU (anything else is refused: a CPU number
            must never pass for a device number); prints the card.
  main      the user's entry points in-process: `train` for the coordinate
            MLP at 128x96x96, H=128 (plain and --fused) and for the NGP
            family at the CLI defaults, then `__graft_entry__.entry()`.
            Losses must be finite and falling.
  parity    at 128x96x96, H=128, seed 777, each error printed beside its
            limit from utils/tolerances.py: the residual stencil against
            the f64 oracle, the kernel pair's fields, loss and gradients
            against the plain generator and the f64 truth, and the bf16
            tier against the same bf16 arithmetic in XLA.
  card      the test suite's `gpu`-marked tests (tests/test_gpu_kernels.py):
            the compiled kernel pair on its edge-case shapes.
  timing    full Adam train steps at 128x96x96, H=128: the plain
            value_and_grad arm against the kernel-pair arm, f32 and bf16,
            in the order plain, pair, pair, plain, with each compiled
            step's memory_analysis.
  four      (--four-cards only) the GSPMD and the fused sharded train steps
            on a 1-D z mesh of four cards at 128x96x384, H=128, five steps,
            against the same steps on one card from the same init.

The last line of stdout is one JSON object with the device JAX reports.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

SEED = 777
FLAGSHIP = (128, 96, 96)
FOUR_CARD_GRID = (128, 96, 384)
H = 128


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_device(count: int):
    import jax

    devices = jax.devices()
    d = devices[0]
    if d.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU, JAX found {d.platform!r}"
        )
    if len(devices) < count:
        raise SystemExit(f"chip_smoke: needs {count} cards, found {len(devices)}")

    from phys_autodiff_tpu.backend import pallas_interpret
    from phys_autodiff_tpu.utils.cache import enable_compile_cache

    assert pallas_interpret() is False  # kernels compile for the card
    print(f"device_kind {d.device_kind}  count {len(devices)}  "
          f"jax {jax.__version__}")
    print(f"XLA_FLAGS {os.environ.get('XLA_FLAGS', '')!r}")
    print(f"compile cache {enable_compile_cache()}")
    print(f"card {card_line()}", flush=True)
    return d


def _grid(nx, ny, nz, **kw):
    from phys_autodiff_tpu.utils.config import GridSpec

    return GridSpec(nx=nx, ny=ny, nz=nz, hx=0.05, hy=0.05, hz=0.05, dt=1e-3,
                    **kw)


def _run_cli(argv: list[str]) -> dict:
    from phys_autodiff_tpu import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"  {' '.join(argv[:-2])}: rc {rc}, loss "
          f"{rec['loss_first']:.6g} -> {rec['loss_last']:.6g}, "
          f"{time.perf_counter() - t0:.1f} s incl. compile", flush=True)
    ok = (rc == 0 and all(map(_finite, (rec["loss_first"], rec["loss_last"])))
          and rec["loss_last"] < rec["loss_first"])
    if not ok:
        raise SystemExit(f"chip_smoke: main path failed: {argv} -> {rec}")
    return rec


def _finite(x) -> bool:
    import math

    return math.isfinite(float(x))


def phase_main(out_dir: str):
    import jax
    import jax.numpy as jnp

    print("== main path", flush=True)
    grid = "x".join(map(str, FLAGSHIP))
    flagship = ["--grid", grid, "--hidden", str(H), "--steps", "20",
                "--seed", str(SEED)]
    _run_cli(["train", *flagship, "--out", f"{out_dir}/mlp.npz"])
    _run_cli(["train", *flagship, "--fused", "--out", f"{out_dir}/mlp_fused.npz"])
    _run_cli(["train", "--family", "ngp", "--steps", "20",
              "--out", f"{out_dir}/ngp.npz"])

    import __graft_entry__

    fn, args = __graft_entry__.entry()
    loss = jax.block_until_ready(jax.jit(fn)(*args))
    if not bool(jnp.isfinite(loss)):
        raise SystemExit(f"chip_smoke: entry() loss {loss}")
    print(f"  entry(): loss {float(loss):.6g}", flush=True)


class Checks:
    """Errors printed beside their limits; a miss fails the phase after
    every check of it has printed."""

    def __init__(self):
        self.missed = []

    def __call__(self, name, value, limit, source):
        ok = float(value) <= float(limit)
        print(f"  {name:<52s} {float(value):.3e}  <= {float(limit):.1e} "
              f"{source:<28s} {'ok' if ok else 'MISS'}", flush=True)
        if not ok:
            self.missed.append(name)

    def info(self, name, value):
        print(f"  {name:<52s} {float(value):.3e}  (reported, no limit)",
              flush=True)

    def close(self, phase):
        if self.missed:
            raise SystemExit(f"chip_smoke: {phase} missed {self.missed}")


def _rel(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _cat(tree):
    import numpy as np

    return np.concatenate(
        [np.asarray(tree[k], np.float64).ravel() for k in sorted(tree)]
    )


def _check_loss_terms(check, what, terms, terms_ref):
    """(L_sigma, L_u), device residuals reduced in f64, vs the oracle's.
    Both come back rounded to f32, so the limit is LOSS_REL or one f32 ulp
    of the oracle's value, whichever is larger; a term that is zero in the
    oracle is held to an absolute 1e-10."""
    import numpy as np

    from phys_autodiff_tpu.utils import tolerances as tol

    for name, a, b in zip(("L_sigma", "L_u"), terms, terms_ref):
        a, b = float(a), float(b)
        if b == 0.0:
            check(f"{what} {name} (f64-reduced) abs vs oracle", abs(a), 1e-10,
                  "zero term")
        else:
            ulp = float(np.spacing(np.float32(abs(b)))) / abs(b)
            check(f"{what} {name} (f64-reduced) vs oracle", abs(a - b) / abs(b),
                  max(tol.LOSS_REL, ulp), "LOSS_REL or 1 f32 ulp")


def phase_parity():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from phys_autodiff_tpu import ops
    from phys_autodiff_tpu.models import fields as fields_mod
    from phys_autodiff_tpu.models import mlp
    from phys_autodiff_tpu.ops.stencil import FieldSnapshots
    from phys_autodiff_tpu.pallas import fieldgen
    from phys_autodiff_tpu.ref import manufactured, oracle
    from phys_autodiff_tpu.ref.f64_grad import f64_loss_and_grad
    from phys_autodiff_tpu.utils import tolerances as tol
    from phys_autodiff_tpu.utils.config import MLPDims, MLPGridConfig, PhysWeights
    from phys_autodiff_tpu.utils.metrics import max_abs_err, rel_l2_err

    check = Checks()
    w = PhysWeights()

    print("== parity: residual stencil vs the f64 oracle, manufactured "
          "solution 2, 128x96x96", flush=True)
    gm = manufactured.periodic_box_spec(*FLAGSHIP)
    f = manufactured.solution2_fields(gm, 0.7)
    fs = FieldSnapshots(**{k: jnp.asarray(v) for k, v in f.items()})
    rs_ref, ru_ref = oracle.residuals(gm, **f)
    rs, ru = jax.jit(lambda x: ops.residuals(gm, x))(fs)
    check("R_sigma rel_l2", rel_l2_err(rs, rs_ref),
          tol.F32_VS_ORACLE_RSIGMA_REL, "F32_VS_ORACLE_RSIGMA_REL")
    check("R_sigma max_abs", max_abs_err(rs, rs_ref),
          tol.F32_VS_ORACLE_RSIGMA_MAX, "F32_VS_ORACLE_RSIGMA_MAX")
    check("R_u rel_l2", rel_l2_err(ru, ru_ref),
          tol.F32_VS_ORACLE_RU_REL, "F32_VS_ORACLE_RU_REL")
    check("R_u max_abs", max_abs_err(ru, ru_ref),
          tol.F32_VS_ORACLE_RU_MAX, "F32_VS_ORACLE_RU_MAX")
    _check_loss_terms(check, "loss", ops.loss_forward_f64(gm, w, fs),
                      oracle.loss_forward(gm, w, **f))
    gs, gu = jax.jit(lambda a, b: ops.loss_backward(gm, w, a, b))(rs, ru)
    gs_ref, gu_ref = oracle.loss_backward(gm, w, rs_ref, ru_ref)
    # the backward is (2 w / N) R: each half inherits its residual's class
    check("loss backward d/dR_sigma rel_l2", rel_l2_err(gs, gs_ref),
          tol.F32_VS_ORACLE_RSIGMA_REL, "F32_VS_ORACLE_RSIGMA_REL")
    check("loss backward d/dR_u rel_l2", rel_l2_err(gu, gu_ref),
          tol.F32_VS_ORACLE_RU_REL, "F32_VS_ORACLE_RU_REL")
    check("loss backward d/dR_u max_abs", max_abs_err(gu, gu_ref),
          tol.F32_VS_ORACLE_RU_MAX, "F32_VS_ORACLE_RU_MAX")
    del fs, rs, ru, gs, gu

    print("== parity: kernel pair, 128x96x96, H=128, seed 777, t=0.25",
          flush=True)
    g = _grid(*FLAGSHIP)
    cfg = MLPGridConfig(dims=MLPDims(H=H))
    params = mlp.init_params(cfg.dims, seed=SEED)
    t = jnp.float32(0.25)

    pair = jax.jit(lambda p: fieldgen.generate_fields(g, cfg, p, t, g.dt))
    plain = jax.jit(lambda p: fields_mod.generate_fields(g, cfg, p, t, g.dt))
    fp, fr = pair(params), plain(params)
    check("fields f32, worst channel rel_l2 vs plain HIGHEST",
          max(rel_l2_err(a, b) for a, b in zip(fp, fr)),
          tol.MLP_INFER_REL, "MLP_INFER_REL")
    _check_loss_terms(check, "loss of the pair's fields",
                      ops.loss_forward_f64(g, w, fp),
                      oracle.loss_forward(g, w, **{
                          k: np.asarray(v) for k, v in fp._asdict().items()}))

    def arm(use_fused):
        from phys_autodiff_tpu.train.loop import loss_fn

        return jax.jit(jax.value_and_grad(
            lambda p: loss_fn(g, w, cfg, p, t, use_fused)))(params)

    # bounds of tests/test_fused_vs_staged.py: two f32 programs whose layer
    # sums associate differently, read through a 1/(2 dt) time difference
    l_pair, g_pair = arm(True)
    l_plain, g_plain = arm(False)
    check("train loss, pair vs plain value_and_grad",
          abs(float(l_pair) - float(l_plain)) / abs(float(l_plain)), 5e-6,
          "test_fused_vs_staged")
    check("grads, pair vs plain value_and_grad rel_l2",
          _rel(_cat(g_pair), _cat(g_plain)), 1e-4, "test_fused_vs_staged")
    for k in sorted(g_plain):
        check(f"grads {k}, pair vs plain rel_l2", _rel(g_pair[k], g_plain[k]),
              1e-3, "test_fused_vs_staged")

    # the backward's own error: both arms' VJPs of one f32 cotangent
    # against the f64 VJP of the same cotangent. W2 and b2 are sums over
    # every cell, slice and unit, so they measure the reduction; W1 and b1
    # also carry each ReLU mask decision, which f32 makes differently from
    # f64 where a pre-activation lies within rounding of zero (reported).
    from phys_autodiff_tpu.ref.f64_grad import f64_fields_fn

    ct = jax.jit(jax.grad(lambda x: ops.total_loss(g, w, x)))(fr)
    vjps = {
        name: jax.jit(lambda p, c, gen=gen: jax.vjp(gen, p)[1](c)[0])(params, ct)
        for name, gen in (
            ("pair", lambda p: fieldgen.generate_fields(g, cfg, p, t, g.dt)),
            ("plain", lambda p: fields_mod.generate_fields(g, cfg, p, t, g.dt)),
        )
    }
    with jax.enable_x64():
        p64 = {k: jnp.asarray(np.asarray(v), jnp.float64)
               for k, v in params.items()}
        ct64 = [(jnp.asarray(np.asarray(s_), jnp.float64),
                 jnp.asarray(np.asarray(u_), jnp.float64))
                for s_, u_ in ((ct.sigma_tm1, ct.u_tm1), (ct.sigma_t, ct.u_t),
                               (ct.sigma_tp1, ct.u_tp1))]
        gen64 = f64_fields_fn(g, cfg.norm)
        v64 = jax.vjp(lambda p: gen64(p, np.float32(0.25)), p64)[1](ct64)[0]
        v64 = {k: np.asarray(v) for k, v in v64.items()}
    for k in ("W2", "b2"):
        check(f"VJP {k}, pair vs f64 VJP of the same cotangent",
              _rel(vjps["pair"][k], v64[k]), tol.GRAD_REL, "GRAD_REL")
    for name, keys in (("pair", ("W1", "b1")),
                       ("plain", ("W1", "b1", "W2", "b2"))):
        for k in keys:
            check.info(f"VJP {k}, {name} vs f64 VJP of the same cotangent",
                       _rel(vjps[name][k], v64[k]))
    l64, g64 = f64_loss_and_grad(g, w, params, 0.25)
    for name, (l32, g32) in (("pair", (l_pair, g_pair)),
                             ("plain", (l_plain, g_plain))):
        check.info(f"train loss, {name} vs f64 truth",
                   abs(float(l32) - l64) / abs(l64))
        check.info(f"grads, {name} vs f64 truth rel_l2",
                   _rel(_cat(g32), _cat(g64)))
    del fp, fr

    print("== parity: bf16 tier vs the same bf16 arithmetic in XLA", flush=True)
    pair16 = jax.jit(lambda p: fieldgen.generate_fields(g, cfg, p, t, g.dt, "bf16"))
    plain16 = jax.jit(
        lambda p: fields_mod.generate_fields(g, cfg, p, t, g.dt, "bf16"))
    fp, fr = pair16(params), plain16(params)
    check("fields bf16, worst channel rel_l2",
          max(rel_l2_err(a, b) for a, b in zip(fp, fr)),
          tol.BF16_REL, "BF16_REL")
    lp = float(jax.jit(lambda x: ops.total_loss(g, w, x))(fp))
    lr = float(jax.jit(lambda x: ops.total_loss(g, w, x))(fr))
    check("loss bf16", abs(lp - lr) / abs(lr), tol.BF16_REL, "BF16_REL")
    check.close("parity")


def phase_card_tests():
    """The test suite's card-only tests (marker `gpu`), in this process."""
    import pytest

    print("== card tests: pytest -m gpu", flush=True)
    os.environ["PHYS_AUTODIFF_TEST_GPU"] = "1"
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(tests, "test_gpu_kernels.py")])
    if rc != 0:
        raise SystemExit(f"chip_smoke: card tests failed (pytest rc {rc})")


def _median_step_ms(compiled, state, n=20, warm=3):
    import jax
    import numpy as np

    for _ in range(warm):
        state, loss = compiled(state)
    jax.block_until_ready(loss)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        state, loss = compiled(state)
        jax.block_until_ready(loss)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3, float(loss)


def phase_timing():
    from phys_autodiff_tpu.train import loop
    from phys_autodiff_tpu.utils.config import MLPDims, MLPGridConfig, PhysWeights

    print("== timing: full Adam train step, 128x96x96, H=128, median of 20 "
          "steps ended by block_until_ready", flush=True)
    g = _grid(*FLAGSHIP)
    mcfg = MLPGridConfig(dims=MLPDims(H=H))
    w = PhysWeights()
    results = {}
    for precision in ("f32", "bf16"):
        compiled, states = {}, {}
        for arm, fused in (("plain", False), ("pair", True)):
            cfg = loop.TrainConfig(use_fused=fused, precision=precision,
                                   seed=SEED)
            states[arm] = loop.init_state(cfg, mcfg)
            compiled[arm] = loop.make_train_step(g, w, mcfg, cfg).lower(
                states[arm]).compile()
            ma = compiled[arm].memory_analysis()
            print(f"  {arm}_{precision} memory_analysis: temp "
                  f"{ma.temp_size_in_bytes} B, argument "
                  f"{ma.argument_size_in_bytes} B, output "
                  f"{ma.output_size_in_bytes} B", flush=True)
        for arm in ("plain", "pair", "pair", "plain"):
            ms, loss = _median_step_ms(compiled[arm], states[arm])
            results.setdefault(f"{arm}_{precision}", []).append(ms)
            print(f"  {arm}_{precision} step {ms:.4f} ms (loss {loss:.6g})",
                  flush=True)
    print("timing " + json.dumps(results), flush=True)


def phase_four_cards():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from phys_autodiff_tpu.models import mlp
    from phys_autodiff_tpu.parallel.sharded import (
        make_sharded_fused_train_step,
        make_sharded_train_step,
    )
    from phys_autodiff_tpu.utils.config import MLPDims, MLPGridConfig, PhysWeights

    # 5 Adam steps, four cards vs one: every step's loss, and the first
    # step's gradient (read from Adam's first moment, which after one step
    # is exactly 0.1 * grad). The fused step reduces its loss in a fixed
    # plane order and its gradient from fixed-order kernel partials on any
    # mesh; it is held to 4 == 1 at 1e-4 (the bound tests/
    # test_fused_vs_staged.py holds two f32 arms to). The GSPMD step's
    # gradient is plain XLA autodiff, whose long f32 reductions (14M terms
    # on one card, a quarter per card on four) carry their own summation
    # error, so it is judged against a referee — the fused one-card
    # gradient — and must be no farther from it on four cards than on one
    # (x1.5, or within 1e-4). The params after 5 steps are reported, not
    # bounded: Adam divides each update by its gradient's own scale, so a
    # component whose gradient is near zero moves by up to lr on a
    # last-bit difference.
    loss_tol, grad_tol = 1e-5, 1e-4
    print(f"== four cards: 1-D z mesh at {FOUR_CARD_GRID}, H={H}, 5 steps vs "
          f"one card from the same init (limits: loss {loss_tol:.0e}, "
          f"first-step gradient {grad_tol:.0e} rel)", flush=True)
    g = _grid(*FOUR_CARD_GRID)
    mcfg = MLPGridConfig(dims=MLPDims(H=H))
    w = PhysWeights()
    devices = jax.devices()
    meshes = {"4": Mesh(np.asarray(devices[:4]), ("z",)),
              "1": Mesh(np.asarray(devices[:1]), ("z",))}
    check = Checks()
    referee = None
    for name, make in (("fused", make_sharded_fused_train_step),
                       ("gspmd", make_sharded_train_step)):
        runs = {}
        for m, mesh in meshes.items():
            step, init = make(g, w, mcfg, mesh)
            p, o = init(mlp.init_params(mcfg.dims, seed=SEED))
            losses = []
            t0 = time.perf_counter()
            for i in range(5):
                p, o, loss = step(p, o, jnp.float32(0.25))
                losses.append(float(loss))
                if i == 0:
                    grad1 = {k: np.asarray(v) / 0.1
                             for k, v in o[0].mu.items()}
            runs[m] = (losses, grad1,
                       {k: np.asarray(v) for k, v in p.items()})
            print(f"  {name} on {m} card(s): losses {losses} "
                  f"({time.perf_counter() - t0:.1f} s incl. compile)",
                  flush=True)
        (l4, g4, p4), (l1, g1, p1) = runs["4"], runs["1"]
        if not (all(map(_finite, l4)) and l4[-1] < l4[0]):
            raise SystemExit(f"chip_smoke: {name} sharded losses {l4}")
        check(f"{name}: worst step loss rel, 4 vs 1",
              max(abs(a - b) / abs(b) for a, b in zip(l4, l1)),
              loss_tol, "stated above")
        if referee is None:
            referee = g1
            check(f"{name}: first-step gradient rel_l2, 4 vs 1",
                  _rel(_cat(g4), _cat(g1)), grad_tol, "stated above")
        else:
            d1 = _rel(_cat(g1), _cat(referee))
            check(f"{name}: first-step gradient vs referee, 4 cards",
                  _rel(_cat(g4), _cat(referee)), max(1.5 * d1, grad_tol),
                  "1 card's own x1.5")
            check.info(f"{name}: first-step gradient vs referee, 1 card", d1)
            check.info(f"{name}: first-step gradient rel_l2, 4 vs 1",
                       _rel(_cat(g4), _cat(g1)))
        for k in sorted(g1):
            check.info(f"{name}: first-step grad {k} rel_l2, 4 vs 1",
                       _rel(g4[k], g1[k]))
        check.info(f"{name}: params rel_l2 after 5 steps, 4 vs 1",
                   _rel(_cat(p4), _cat(p1)))
    check.close("four cards")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)
    count = 4 if args.four_cards else 1
    d = phase_device(count)

    if args.four_cards:
        phase_four_cards()
    else:
        from phys_autodiff_tpu.utils.cache import default_cache_dir

        out_dir = str(default_cache_dir().parent / "chip_smoke")
        os.makedirs(out_dir, exist_ok=True)
        phase_main(out_dir)
        phase_parity()
        phase_card_tests()
        phase_timing()

    import jax

    print(f"card {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
