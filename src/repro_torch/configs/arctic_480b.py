"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab_size=32000,
    norm_type="rmsnorm", mlp_type="swiglu",
    moe=True, n_experts=128, n_experts_per_token=2,
    dense_residual_ff=4864,        # Arctic dense-MoE hybrid residual path
    moe_capacity_factor=1.25,
    fsdp=True,
    param_dtype="bfloat16",
    opt_state_dtype="bfloat16",
    optimizer="adafactor",
)
