"""bench.py: the headline record, the device it names, and its refusal to
measure anywhere but on a GPU (a CPU number must never pass for a device
number)."""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import bench  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"


def _device(kind=H100):
    return {"platform": "gpu", "kind": kind, "count": 1,
            "power_limit": f"{kind}, 700.00 W"}


def test_headline_math():
    rec = bench.headline(bench.BASELINE_MS, _device())
    assert rec["value"] == pytest.approx(
        bench.N_CELLS_FLAGSHIP / (bench.BASELINE_MS / 1e3) / 1e9)
    assert rec["vs_baseline"] == pytest.approx(1.0)
    assert bench.headline(bench.BASELINE_MS / 2, _device())["vs_baseline"] == (
        pytest.approx(2.0))
    assert rec["unit"] == "Gcell_iters_per_s"
    assert rec["ms"] == bench.BASELINE_MS


def test_headline_names_the_device_and_is_json():
    rec = json.loads(json.dumps(bench.headline(0.05, _device())))
    assert rec["device"]["kind"] == H100
    assert rec["device"]["platform"] == "gpu"
    assert "W" in rec["device"]["power_limit"]


def test_headline_roofline_against_the_peak_table():
    ms = 0.05
    rec = bench.headline(ms, _device())
    want = (bench.N_CELLS_FLAGSHIP * bench.BYTES_PER_CELL / 3.35e12) / (ms / 1e3)
    assert rec["roofline"]["bound"] == "memory"
    assert rec["roofline"]["share"] == pytest.approx(want)


def test_headline_unknown_device_raises():
    with pytest.raises(KeyError, match="no published peaks"):
        bench.headline(0.05, _device("NVIDIA A100-SXM4-80GB"))


@pytest.mark.parametrize("platform", ["cpu", "rocm"])
def test_device_info_refuses_non_gpu(monkeypatch, platform):
    import jax

    fake = SimpleNamespace(platform=platform, device_kind="x")
    monkeypatch.setattr(jax, "devices", lambda: [fake])
    with pytest.raises(RuntimeError, match="GPU"):
        bench.device_info()


def test_device_info_reports_the_gpu(monkeypatch):
    import jax

    fake = SimpleNamespace(platform="gpu", device_kind=H100)
    monkeypatch.setattr(jax, "devices", lambda: [fake, fake])
    monkeypatch.setattr(bench, "power_limit", lambda: f"{H100}, 400.00 W")
    info = bench.device_info()
    assert info == {"platform": "gpu", "kind": H100, "count": 2,
                    "power_limit": f"{H100}, 400.00 W"}


def test_power_limit_reads_nvidia_smi(monkeypatch):
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return SimpleNamespace(stdout=f"{H100}, 700.00 W\n{H100}, 700.00 W\n")

    monkeypatch.setattr(bench.subprocess, "run", run)
    assert bench.power_limit() == f"{H100}, 700.00 W"
    assert calls[0][:2] == ["nvidia-smi", "--query-gpu=name,power.limit"]


def test_bench_refuses_the_cpu_and_prints_no_result():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "bench.py"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
