"""Architecture configuration (port of ``repro/configs/base.py``).

``ModelConfig`` and ``reduced()`` are copied field for field so that a
config here and its counterpart in the JAX package describe the same
model; ``pdtype``/``cdtype`` return ``torch.dtype``s.  Every one of the
reference's ``ASSIGNED_ARCHS`` is registered (``_ensure_loaded``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    # every `period`-th layer is MoE (offset by `first_dense` dense layers)
    layer_period: int = 1
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 = no query compression (V2-Lite)
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    variant: str = "mamba"        # "mamba" | "xlstm"
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    # hybrid (jamba): one attention layer every `attn_period` layers; 0 = none
    attn_period: int = 0
    # xlstm: within each superblock of size `xlstm_period`, index 0 is sLSTM
    xlstm_slstm_ratio: int = 0    # 1 sLSTM per this many blocks; 0 = all mLSTM
    chunk_size: int = 64          # chunkwise-parallel mLSTM/mamba chunk


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 → d_model // num_heads
    source: str = ""              # citation for the config numbers

    # attention
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    attn_variant: str = "full"    # full | sliding
    sliding_window: int = 4096
    causal: bool = True           # False → encoder (bidirectional)

    # ffn
    mlp_variant: str = "swiglu"   # swiglu | geglu | gelu
    norm_variant: str = "rmsnorm" # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # modality frontend stubs (audio/vlm): embeddings arrive precomputed
    frontend_dim: int = 0         # 0 = token-only input
    num_prefix_embeds: int = 0    # positions consumed by frontend embeddings

    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    # which parallelism the launcher applies at production scale
    fsdp: bool = False            # shard params over the data axis too

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ---- derived -----------------------------------------------------
    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def supports_decode(self) -> bool:
        return self.causal

    def supports_long_context(self) -> bool:
        """True if long_500k decode is sub-quadratic/sub-linear-memory: a
        recurrent state (SSM, hybrid), a compressed KV cache (MLA) or a
        sliding window stands in for a full KV cache."""
        if self.family in ("ssm", "hybrid"):
            return True
        if self.mla is not None:
            return True
        return self.attn_variant == "sliding"

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def moe_layer_flags(self) -> list[bool]:
        """Per-layer is-MoE flags from the MoE schedule."""
        if self.moe is None:
            return [False] * self.num_layers
        flags = []
        for i in range(self.num_layers):
            if i < self.moe.first_dense_layers:
                flags.append(False)
            else:
                flags.append(((i - self.moe.first_dense_layers) % self.moe.layer_period) == 0)
        return flags

    def attn_layer_flags(self) -> list[bool]:
        """Per-layer uses-attention flags (hybrid archs)."""
        if self.family in ("ssm",):
            return [False] * self.num_layers
        if self.family == "hybrid" and self.ssm is not None and self.ssm.attn_period > 0:
            return [(i % self.ssm.attn_period) == (self.ssm.attn_period - 1)
                    for i in range(self.num_layers)]
        return [True] * self.num_layers

    def num_params(self) -> int:
        """Analytic parameter count (the reference's formula, biases excluded)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        H, Hkv, dh = self.num_heads, self.num_kv_heads, self.head_dim
        n = V * D * (1 if self.tie_embeddings else 2)
        mult = 3 if self.mlp_variant in ("swiglu", "geglu") else 2
        attn_flags = self.attn_layer_flags()
        moe_flags = self.moe_layer_flags()
        for i in range(L):
            n += 2 * D                 # two norms
            if attn_flags[i]:
                if self.mla is not None:
                    m = self.mla
                    n += D * (H * (m.nope_head_dim + m.rope_head_dim))   # q proj
                    n += D * (m.kv_lora_rank + m.rope_head_dim)         # kv down
                    n += m.kv_lora_rank * H * (m.nope_head_dim + m.v_head_dim)
                    n += H * m.v_head_dim * D                           # out
                else:
                    n += D * H * dh + 2 * D * Hkv * dh + H * dh * D
            elif self.ssm is not None:
                n += self._ssm_block_params()
            if self.family == "ssm":
                pass                    # ssm blocks have no separate FFN
            elif moe_flags[i]:
                m = self.moe
                n += (m.num_experts + m.num_shared_experts) * mult * D * m.d_ff_expert
                n += D * m.num_experts  # router
            else:
                n += mult * D * F
        if self.family == "ssm":
            n += L * self._ssm_block_params()
        if self.frontend_dim:
            n += self.frontend_dim * D * 2
        return n

    def _ssm_block_params(self) -> int:
        if self.ssm is None:
            return 0
        D = self.d_model
        if self.ssm.variant == "xlstm":
            return 4 * D * D + 3 * D * self.num_heads
        di = self.ssm.expand * D
        ds = self.ssm.d_state
        return 2 * D * di + di * self.ssm.d_conv + di * (2 * ds + 1) + di * D

    def num_active_params(self) -> int:
        """Active params per token (MoE: only the routed top-k + shared)."""
        if self.moe is None:
            return self.num_params()
        m = self.moe
        mult = 3 if self.mlp_variant in ("swiglu", "geglu") else 2
        inactive = (m.num_experts - m.top_k) * mult * self.d_model * m.d_ff_expert
        return self.num_params() - sum(self.moe_layer_flags()) * inactive

    # ---- smoke-scale variant ------------------------------------------
    def reduced(self) -> "ModelConfig":
        """≤2 layers (or superblocks), d_model ≤ 512, ≤4 experts, f32."""
        d_model = min(self.d_model, 256)
        num_heads = min(self.num_heads, 4)
        num_kv_heads = max(1, min(self.num_kv_heads, num_heads))
        # keep the GQA ratio shape: kv must divide heads
        while num_heads % num_kv_heads:
            num_kv_heads -= 1
        head_dim = max(16, d_model // num_heads)
        changes = dict(
            num_layers=2 if self.family not in ("hybrid", "ssm") else 4,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv_heads,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=64,
            param_dtype="float32",
            compute_dtype="float32",
            fsdp=False,
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=min(self.moe.d_ff_expert, 256),
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                first_dense_layers=min(self.moe.first_dense_layers, 1),
            )
        if self.mla is not None:
            changes["mla"] = dataclasses.replace(
                self.mla, kv_lora_rank=64, rope_head_dim=16,
                nope_head_dim=head_dim, v_head_dim=head_dim)
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_state=8, chunk_size=16,
                attn_period=min(self.ssm.attn_period, 4) if self.ssm.attn_period else 0)
            if self.family == "hybrid":
                changes["num_layers"] = changes["ssm"].attn_period or 4
        if self.frontend_dim:
            changes["frontend_dim"] = 64
            changes["num_prefix_embeds"] = min(self.num_prefix_embeds, 16)
        return dataclasses.replace(self, **changes)


# --------------------------------------------------------------------------
_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False

ASSIGNED_ARCHS = (
    "starcoder2-3b", "deepseek-v2-lite-16b", "llama4-maverick-400b-a17b",
    "xlstm-1.3b", "gemma-2b", "hubert-xlarge", "llava-next-mistral-7b",
    "stablelm-3b", "jamba-1.5-large-398b", "qwen2.5-14b",
)


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    import importlib
    for arch in ASSIGNED_ARCHS:
        importlib.import_module(f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")
