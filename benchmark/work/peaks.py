"""Published peaks of the chips the benchmark runs on: NVIDIA's data
sheet of the H100 SXM (80 GB HBM3), dense rates, at its 700 W limit."""

H100_SXM = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops_per_s": 67e12,      # float32 outside the tensor cores
    "tf32_flops_per_s": 495e12,
    "bf16_flops_per_s": 989e12,
}


def peaks(kind: str) -> dict:
    """The peaks of a card by its `torch.cuda.get_device_name`; every card
    the benchmark knows is an H100 SXM."""
    if "H100" not in kind:
        raise ValueError(f"no published peaks for {kind!r}")
    return H100_SXM
