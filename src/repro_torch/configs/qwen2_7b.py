"""qwen2-7b [dense] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — GQA, QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab_size=152064,
    norm_type="rmsnorm", mlp_type="swiglu",
    qkv_bias=True,                 # Qwen2 signature
    rope_theta=1_000_000.0,
    fsdp=True,
)
