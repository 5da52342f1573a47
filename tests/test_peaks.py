"""The published-peak table (bench/peaks.py): keyed by JAX's device_kind,
and an unknown device is an error, never a default."""

import pytest

from phys_autodiff_tpu.bench.peaks import PEAKS, peaks_for, roofline_share

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("key, value", [
    ("hbm_tb_s", 3.35), ("bf16_tflop_s", 989.0), ("tf32_tflop_s", 495.0),
    ("f32_tflop_s", 67.0),
])
def test_h100_sxm_data_sheet_rates(key, value):
    assert peaks_for(H100)[key] == value


@pytest.mark.parametrize("kind", [
    "NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", "cpu", "", "nvidia h100 80gb hbm3",
])
def test_unknown_device_kind_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        peaks_for(kind)


def test_every_entry_has_every_rate():
    for kind, entry in PEAKS.items():
        assert set(entry) == {"hbm_tb_s", "bf16_tflop_s", "tf32_tflop_s",
                              "f32_tflop_s"}, kind
        assert all(v > 0 for v in entry.values()), kind


def test_roofline_memory_bound():
    # 3.35 GB in 2 ms at 3.35 TB/s peak: the floor is 1 ms, share 0.5
    r = roofline_share(2.0, 3.35e9, 1e6, H100)
    assert r["bound"] == "memory"
    assert r["share"] == pytest.approx(0.5)


def test_roofline_compute_bound():
    # 67 GFLOP f32 in 4 ms at 67 TFLOP/s: the floor is 1 ms, share 0.25
    r = roofline_share(4.0, 1e3, 67e9, H100)
    assert r["bound"] == "compute"
    assert r["share"] == pytest.approx(0.25)


def test_roofline_uses_the_dtype_peak():
    f32 = roofline_share(1.0, 1.0, 67e9, H100, "f32")
    bf16 = roofline_share(1.0, 1.0, 67e9, H100, "bf16")
    assert f32["share"] / bf16["share"] == pytest.approx(989.0 / 67.0)
