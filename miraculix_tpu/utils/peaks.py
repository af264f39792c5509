"""Published peak rates of the accelerators this package is measured on,
keyed by ``jax.Device.device_kind``.

Roofline shares are computed against these numbers.  A device that is not
in the table raises: no peak is assumed for an unknown device.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates (no sparsity), at the card's full
# 700 W power limit; a card set below that limit cannot hold its top clock
# under a matrix-heavy load, so report the limit beside any share.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "int8_ops": 1979e12,
        "tf32_flops": 495e12,
        "f32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 SXM data sheet (dense, 700 W)",
    },
}


def device_peaks(device=None) -> dict:
    """Peak rates of ``device`` (default: the first JAX device)."""
    import jax

    kind = (device or jax.devices()[0]).device_kind
    if kind not in PEAKS:
        raise KeyError(f"no published peaks recorded for device kind "
                       f"{kind!r}; add them to miraculix_tpu.utils.peaks")
    return PEAKS[kind]
