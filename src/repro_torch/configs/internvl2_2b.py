"""internvl2-2b [vlm] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553 — InternViT + InternLM2 [arXiv:2404.16821; hf].
Vision frontend is a STUB per the assignment: input_specs supplies
precomputed patch embeddings (InternViT output, 1024-d) which the
learned projector maps into d_model."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab_size=92553,
    norm_type="rmsnorm", mlp_type="swiglu",
    frontend="vision_stub", num_patches=256,
)
