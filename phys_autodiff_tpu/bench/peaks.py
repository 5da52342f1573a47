"""Published peak rates of the accelerators the benchmark reports against,
keyed by JAX's `device_kind`.

Source: NVIDIA H100 Tensor Core GPU data sheet, SXM part, dense rates
(without sparsity), which assume the full 700 W power limit. A card set
below it cannot hold its top clock under load, so every number reported
against these peaks carries the card's power limit beside it.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_tb_s": 3.35,
        "bf16_tflop_s": 989.0,
        "tf32_tflop_s": 495.0,
        "f32_tflop_s": 67.0,
    },
}


def peaks_for(device_kind: str) -> dict:
    """The peak table entry of `device_kind`; an unknown device is an
    error, never a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r} "
            f"(known: {sorted(PEAKS)})"
        ) from None


def roofline_share(ms: float, bytes_moved: float, flops: float,
                   device_kind: str, flop_dtype: str = "f32") -> dict:
    """Least time the device could take for the work (the larger of bytes
    over peak bandwidth and FLOPs over peak rate) divided by the measured
    time, with the bound that sets it."""
    pk = peaks_for(device_kind)
    t_mem = bytes_moved / (pk["hbm_tb_s"] * 1e12)
    t_flop = flops / (pk[f"{flop_dtype}_tflop_s"] * 1e12)
    bound = "memory" if t_mem >= t_flop else "compute"
    return {"share": max(t_mem, t_flop) / (ms / 1e3), "bound": bound}
