"""Hardware model of the target card: one NVIDIA H100 SXM5 80GB.

The values are the card's datasheet figures, which the roofline overlap
model (``roofline/overlap.py``) and the autotuner (``core/autotune.py``)
rank candidate plans with, and the dry run's roofline
(``roofline/model.py``) prices its counts at.  They are what the card can do at most, not
what the port measured: the card this port is measured on reports itself
as "NVIDIA H100 80GB HBM3, 700.00 W" (``nvidia-smi --query-gpu=name,
power.limit``), and a card set to a lower power limit runs slower under
load than these figures say.

  989 TFLOP/s dense bf16 tensor-core math, 3.35 TB/s HBM3, 80 GB,
  18 NVLink-4 links of 25 GB/s each way (450 GB/s each way, 900 GB/s
  both ways).
"""

PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 (no sparsity)
HBM_BW = 3.35e12          # bytes/s
HBM_BYTES = 80e9          # bytes of device memory
NVLINK_BW_PER_LINK = 25e9  # bytes/s per link, each way (NVLink 4)
NVLINK_LINKS = 18         # links per card
# Launch latency of one collective (ring setup plus per-hop latency).
# An assumption, not a measurement: no collective runs across cards on
# one card, so this figure waits for a four-card measurement (ROADMAP
# queue 1, item 9).  It is the order of an NCCL all-reduce of a small
# message over NVLink within one node.
COLL_LATENCY_S = 10e-6

DTYPE_BYTES = {
    "float32": 4, "f32": 4,
    "bfloat16": 2, "bf16": 2,
    "float16": 2, "f16": 2,
    "int8": 1, "s8": 1, "u8": 1, "uint8": 1,
    "int32": 4, "s32": 4, "u32": 4, "uint32": 4,
    "int64": 8, "s64": 8, "u64": 8, "uint64": 8,
    "float64": 8, "f64": 8,
    "bool": 1, "pred": 1,
    "int16": 2, "s16": 2, "u16": 2, "uint16": 2,
    "float8_e4m3fn": 1, "f8e4m3fn": 1, "float8_e5m2": 1, "f8e5m2": 1,
}
