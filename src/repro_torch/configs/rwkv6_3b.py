"""rwkv6-3b [ssm] — 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536 —
Finch, data-dependent decay [arXiv:2404.05892; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,  # d/head_size
    d_ff=8960, vocab_size=65536,
    norm_type="layernorm",
    block_pattern=("rwkv",),
    rwkv_head_size=64, rwkv_lora_rank=32,
    rope_fraction=0.0,
    fsdp=True,
)
