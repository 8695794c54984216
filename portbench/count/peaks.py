"""Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, no
sparsity, at the full 700 W power limit). A card set to a lower limit runs
under them; every run records its card's limit beside its numbers."""

FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
