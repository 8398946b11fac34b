"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at its 700 W power limit).  A card set to a
lower limit runs below them; the harness prints the card's limit beside
every result."""

HBM_BYTES_PER_S = 3.35e12

# operations a second by pipe
PIPES = {
    "fp32": 67e12,      # float32 outside the tensor cores
    "tf32": 495e12,     # TF32 tensor cores
    "bf16": 989e12,     # bfloat16 tensor cores
    "int8": 1979e12,    # int8 tensor cores
}

CARD = "NVIDIA H100 80GB HBM3"
