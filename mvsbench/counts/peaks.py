"""Published peaks of one NVIDIA H100 SXM (data sheet; dense, at the
700 W limit).

TF32 is the highest rate that a float32 configuration's arithmetic
allows (cuDNN may use TF32 for its convolutions; nothing runs faster), so
it is the peak that float32 work is held against, and no share of it can
pass 100%.
"""

TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
