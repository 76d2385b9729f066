"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W limit). A frozen copy of
``chip_smoke.py`` lines 584-588 at the commit that added this benchmark."""

PEAK_F32_FLOPS = 67e12       # float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12         # HBM3, bytes/s
