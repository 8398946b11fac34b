"""hubert-xlarge [audio] — 48L d_model=1280 16H (GQA kv=16) d_ff=5120
vocab=504 — encoder-only, same arch as wav2vec2 [arXiv:2106.07447;
unverified].  Audio frontend is a STUB per the assignment: input_specs
supplies precomputed frame embeddings (conv-extractor output, 512-d);
the framework adds the learned projection + TINA depthwise-FIR
convolutional positional embedding.  The real front-end op (a polyphase
channelizer) is demonstrated with TINA's own PFB in
examples/pfb_features.py."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab_size=504,
    norm_type="layernorm", mlp_type="gelu",
    causal=False,                  # bidirectional encoder
    rope_fraction=0.0,             # conv positional embedding instead
    frontend="audio_stub",
    fsdp=True,
)
