"""chip_smoke.py refuses anything but a GPU and prints no result there;
its check bookkeeping fails a phase only after every check has printed."""

import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


@pytest.mark.parametrize("args", [[], ["--four-cards"]],
                         ids=["one", "four"])
def test_refuses_the_cpu(args):
    out = _run(args, ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs an NVIDIA GPU" in out.stderr


def test_fails_alone_without_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run([], tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_refuses_too_few_cards(monkeypatch):
    import jax

    fake = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(jax, "devices", lambda: [fake])
    with pytest.raises(SystemExit, match="needs 4 cards"):
        chip_smoke.phase_device(4)


def test_checks_print_every_miss_then_fail(capsys):
    check = chip_smoke.Checks()
    check("a", 2e-7, 1e-7, "LOSS_REL")
    check("b", 1e-8, 1e-7, "LOSS_REL")
    check("c", 5.0, 1.0, "X")
    out = capsys.readouterr().out
    assert out.count("MISS") == 2 and out.count(" ok") == 1
    with pytest.raises(SystemExit, match=r"\['a', 'c'\]"):
        check.close("parity")


def test_checks_pass_quietly():
    check = chip_smoke.Checks()
    check("a", 0.0, 1e-7, "LOSS_REL")
    check.info("b", 3.0)
    check.close("parity")


def test_zero_loss_term_is_held_absolutely(capsys):
    check = chip_smoke.Checks()
    chip_smoke._check_loss_terms(check, "loss", (1.0, 0.0), (1.0, 0.0))
    chip_smoke._check_loss_terms(check, "loss", (1.0, 1e-6), (1.0, 0.0))
    assert check.missed == ["loss L_u (f64-reduced) abs vs oracle"]
