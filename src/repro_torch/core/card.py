"""The card's rates: the one table that the cost model
(``core/costmodel.HW``) and ``chip_smoke.py``'s kernel bounds read, so a
kernel's bound and a step's roofline cannot use different peaks.

NVIDIA H100 SXM5 80 GB (the card the port runs on; ``nvidia-smi`` names
it "NVIDIA H100 80GB HBM3").  Every figure is a published peak, not a
measurement, and each gives its source.  The port's f32 steps run with
TF32 off (``chip_smoke.py`` sets ``allow_tf32 = False``), so f32 work is
priced at the CUDA cores' rate.
"""
from __future__ import annotations

# NVIDIA H100 Tensor Core GPU datasheet, SXM5 column: dense BF16 tensor
# core 989 TFLOP/s (1,979 is the 2:4-sparse figure)
FLOPS_BF16 = 989e12
# the same datasheet: dense TF32 tensor core 495 TFLOP/s (989 sparse)
FLOPS_TF32 = 495e12
# the same datasheet: FP32 on the CUDA cores, 67 TFLOP/s
FLOPS_F32 = 67e12
# the same datasheet: HBM3, 3.35 TB/s and 80 GB
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9
# the same datasheet: NVLink 4, 900 GB/s per GPU counting both
# directions; a ring collective moves data one way, 450 GB/s
NVLINK_BYTES_PER_S = 450e9
# between nodes: one ConnectX-7 400 Gb/s NDR InfiniBand port per GPU
# (DGX H100 user guide: eight single-port ConnectX-7 for the compute
# fabric), 50 GB/s each way
NET_BYTES_PER_S = 50e9
# cards joined by NVLink in one node (HGX / DGX H100: eight)
NODE_SIZE = 8
# ASSUMPTION, not measured: the fixed cost of one collective (a launch
# and a handshake of NCCL's ring).  One card cannot run a collective
# across cards, so no run of this repo measures it.
COLLECTIVE_LATENCY_S = 1e-5
