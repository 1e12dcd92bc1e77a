"""Published peaks of the cards the roofline tools divide by, keyed by
``jax.devices()[0].device_kind``. Source: NVIDIA H100 data sheet, SXM part
(HBM3 80 GB at 3.35 TB/s). A kind that is not listed is an error."""

HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_bytes_per_s(device_kind):
    try:
        return HBM_BYTES_PER_S[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peak for device kind {device_kind!r}; add it to "
            "tools/device_peaks.py"
        ) from None
