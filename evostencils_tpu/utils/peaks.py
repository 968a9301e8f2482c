"""Published peak rates of the accelerators this program runs on.

One table, keyed by ``jax.Device.device_kind``.  A device that is not in
the table is an error: a roofline share or a model prediction against a
guessed peak would be a number without meaning.

Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part at its 700 W
power limit — 3.35 TB/s HBM3 and 67 TFLOP/s float32 outside the tensor
cores (dense rates, no sparsity).  A card set below 700 W
(``nvidia-smi --query-gpu=power.limit``) cannot hold these under load.
"""

from __future__ import annotations

from typing import NamedTuple


class Peaks(NamedTuple):
    hbm_bytes_per_s: float
    f32_flops: float
    source: str


PEAKS = {
    "NVIDIA H100 80GB HBM3": Peaks(
        hbm_bytes_per_s=3.35e12,
        f32_flops=67e12,
        source="NVIDIA H100 data sheet, SXM5, 700 W",
    ),
}


def peaks_for(device_kind: str) -> Peaks:
    """Peaks of ``device_kind``; raises KeyError for an unknown device."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}"
        ) from None


def current_device_peaks() -> Peaks:
    import jax

    return peaks_for(jax.devices()[0].device_kind)
