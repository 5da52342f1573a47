"""The one platform dispatch (phys_autodiff_tpu/backend.py)."""

from pathlib import Path

import jax
import pytest

from phys_autodiff_tpu import backend

PKG = Path(backend.__file__).resolve().parent


def test_gpu_compiles_the_kernels():
    assert backend.pallas_interpret("gpu") is False


def test_cpu_interprets_the_kernels():
    assert backend.pallas_interpret("cpu") is True


@pytest.mark.parametrize("platform", ["rocm", "METAL", "cuda", "neuron", ""])
def test_unknown_platforms_have_no_route(platform):
    with pytest.raises(RuntimeError, match="no kernel route"):
        backend.pallas_interpret(platform)


def test_default_is_the_running_backend():
    assert jax.default_backend() == "cpu"
    assert backend.pallas_interpret() is True


def test_fieldgen_takes_its_mode_from_the_dispatch(monkeypatch):
    from phys_autodiff_tpu.models import mlp
    from phys_autodiff_tpu.pallas import fieldgen
    from phys_autodiff_tpu.utils.config import GridSpec, MLPDims, MLPGridConfig

    def refuse(platform=None):
        raise RuntimeError("no kernel route for platform 'x'")

    monkeypatch.setattr(fieldgen, "pallas_interpret", refuse)
    g = GridSpec(nx=8, ny=4, nz=2, dt=1e-2)
    cfg = MLPGridConfig(dims=MLPDims(H=16))
    with pytest.raises(RuntimeError, match="no kernel route"):
        fieldgen.generate_fields(g, cfg, mlp.init_params(cfg.dims), 0.25)


def test_no_other_module_branches_on_the_platform():
    """Only backend.py asks which platform runs; every other module goes
    through it (no hidden per-platform arms)."""
    offenders = [
        str(p.relative_to(PKG)) for p in PKG.rglob("*.py")
        if p.name != "backend.py" and "default_backend()" in p.read_text()
        and "cli.py" not in str(p)
    ]
    assert offenders == []


def test_every_pallas_call_names_the_triton_route():
    for p in PKG.rglob("*.py"):
        text = p.read_text()
        calls = text.count("pl.pallas_call(")
        assert text.count('backend="triton"') >= calls, p
