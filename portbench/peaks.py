"""Published peaks of the cards the benchmark runs on, by the name
`torch.cuda.get_device_name()` gives.

NVIDIA's H100 data sheet, SXM part, dense rates: 3.35 TB/s of HBM3 and
67 TFLOP/s float32 outside the tensor cores, at the card's full 700 W.  A
card set below that limit runs slower; each run prints `power.limit`
beside its numbers.
"""

H100_SXM = {"bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12}

PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def peaks(device_name: str) -> dict | None:
    """The peaks of `device_name`, or None for a card not in the table (a
    share of its peak then goes unreported)."""
    return PEAKS.get(device_name)
