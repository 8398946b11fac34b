"""Model configuration schema shared by all 10 assigned architectures:
the reference's ``repro.models.config``, field for field.

``tina_lowering`` takes ``native | conv | kernel``: ``kernel`` is the
port's name for the reference's ``pallas`` (the hand-written GEMM
kernels of :mod:`repro_torch.kernels.matmul`), as everywhere in the
port."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // n_heads

    # --- layer flavour ------------------------------------------------
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm | nonparam_ln
    qkv_bias: bool = False
    mlp_type: str = "swiglu"         # swiglu | geglu | gelu
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0       # partial rotary (stablelm: 0.25)
    causal: bool = True              # False => bidirectional encoder
    tie_embeddings: bool = False

    # --- MoE ------------------------------------------------------------
    moe: bool = False
    n_experts: int = 0
    n_experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    dense_residual_ff: int = 0       # arctic: parallel dense FFN width
    shared_experts: int = 0          # kimi: always-on experts
    moe_dispatch: str = "gspmd"      # gspmd | shard_map (§Perf: local
                                     # route/sort + EP-local experts +
                                     # bf16 psum combine — avoids GSPMD's
                                     # global-sort collectives)

    # --- hybrid (recurrentgemma) -----------------------------------------
    block_pattern: tuple = ("attn",)  # cycled; "attn" | "rglru" | "rwkv"
    local_window: int = 0             # sliding-window attention (0 = full)
    conv_width: int = 4               # temporal conv in recurrent block
    lru_width: Optional[int] = None

    # --- rwkv -------------------------------------------------------------
    rwkv_head_size: int = 64
    rwkv_lora_rank: int = 32

    # --- modality frontends (stubs per assignment) -------------------------
    frontend: Optional[str] = None    # None | "vision_stub" | "audio_stub"
    num_patches: int = 256            # vlm patch positions per image

    # --- implementation knobs ----------------------------------------------
    tina_lowering: str = "native"     # native | conv | kernel (TINA dispatch)
    use_tina: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    attn_chunk: int = 1024            # online-softmax KV chunk
    use_scan: bool = True
    remat: bool = True
    remat_group: int = 1              # >1: sqrt-remat — outer scan over
                                      # groups of this many superblocks
                                      # saves only group inputs (peak
                                      # residual memory /= remat_group)

    # --- parallelism ----------------------------------------------------
    fsdp: bool = False                # shard params over data axis too
    opt_state_dtype: str = "float32"  # bf16 for the 1T-class models
    optimizer: str = "adamw"          # adamw | adafactor (1T-class MoE)

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def rotary_dim(self) -> int:
        r = int(self.head_dim * self.rope_fraction)
        return r - (r % 2)

    @property
    def attention_free(self) -> bool:
        return all(b == "rwkv" for b in self.block_pattern)

    @property
    def layer_kinds(self) -> tuple:
        """Per-layer block kind, cycling the pattern."""
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)


def reduced(cfg: ModelConfig, **extra) -> ModelConfig:
    """Smoke-test-sized version of any config: same family/flavour, tiny
    dims.  Keeps divisibility invariants (heads, kv groups, experts)."""
    n_kv = min(cfg.n_kv_heads, 2)
    n_heads = max(2, (4 // max(1, 4 // max(cfg.n_heads, 1))))
    n_heads = 4 if cfg.n_heads >= 4 else cfg.n_heads
    n_kv = min(cfg.n_kv_heads, n_heads)
    if n_heads % n_kv:
        n_kv = 1
    over = dict(
        n_layers=min(cfg.n_layers, len(cfg.block_pattern) * 2),
        d_model=128,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 8) if cfg.moe else 0,
        n_experts_per_token=min(cfg.n_experts_per_token, 2) if cfg.moe else 0,
        dense_residual_ff=128 if cfg.dense_residual_ff else 0,
        shared_experts=min(cfg.shared_experts, 1),
        lru_width=128 if cfg.lru_width else None,
        local_window=min(cfg.local_window, 64) if cfg.local_window else 0,
        rwkv_head_size=32,
        rwkv_lora_rank=8,
        num_patches=8,
        attn_chunk=64,
        param_dtype="float32",
        compute_dtype="float32",
        fsdp=False,
    )
    over.update(extra)
    return cfg.scaled(**over)
