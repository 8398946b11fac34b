"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048
(per expert) vocab=163840, MoE 384 experts top-8 — trillion-param MoE
(paper-table) [arXiv:2501.kimi2; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab_size=163840,
    norm_type="rmsnorm", mlp_type="swiglu",
    moe=True, n_experts=384, n_experts_per_token=8,
    shared_experts=1,
    moe_capacity_factor=1.25,
    fsdp=True,
    param_dtype="bfloat16",        # 1T params: bf16 master + bf16 opt state
    opt_state_dtype="bfloat16",
    optimizer="adafactor",        # O(n+m) second moment: 1T opt state must not be 2x params
)
