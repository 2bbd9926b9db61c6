"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).  The benchmark's
own copy: rooflines and MFU are shares of these."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {
    "bfloat16": 989e12,
    "float16": 989e12,
    # an f32 product may run on the tensor cores in TF32 (or in three
    # bf16/TF32 passes): its least time is taken at the TF32 rate, so
    # that no f32 kernel can read above its roofline
    "float32": 495e12,
}
# the chip's peak for the whole step's share (mfu): the bf16 rate
MFU_PEAK = FLOPS["bfloat16"]


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the chip could take: the larger of the operations
    at the operands' rate and the bytes at the memory's."""
    return max(flops / FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
