"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W power limit)."""

FP32_FLOP_S = 67e12      # float32 outside the tensor cores (an FMA is 2)
HBM_BYTES_S = 3.35e12    # HBM3
