"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (GQA kv=1, i.e. MQA)
d_ff=12288 vocab=256000 — RG-LRU + local attn, 1 attn : 2 recurrent
[arXiv:2402.19427; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab_size=256000,
    norm_type="rmsnorm", mlp_type="geglu",
    block_pattern=("rglru", "rglru", "attn"),   # Griffin 2:1 pattern
    local_window=2048, conv_width=4, lru_width=4096,
    fsdp=True,
)
