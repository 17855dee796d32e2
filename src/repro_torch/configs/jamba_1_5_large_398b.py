"""Jamba-1.5-Large (398B total / 94B active) [arXiv:2403.19887].

Hybrid Mamba + attention at a 1:7 ratio (one attention layer per 8),
MoE (16 experts, top-2) every other layer, GQA kv=8 on the attention
layers.  Recurrent Mamba state + sparse attention layers => long_500k runs
(attention-layer KV cache at 500k is 1/8 of a dense model's).  A full
forward needs a sequence length that is a multiple of ``chunk_size``.
"""
from repro_torch.configs.base import MoEConfig, ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    source="arXiv:2403.19887",
    rope_theta=1e4,
    mlp_variant="swiglu",
    moe=MoEConfig(
        num_experts=16,
        top_k=2,
        d_ff_expert=24576,
        num_shared_experts=0,
        layer_period=2,        # MoE every other layer
        first_dense_layers=1,
    ),
    ssm=SSMConfig(
        variant="mamba",
        d_state=16,
        d_conv=4,
        expand=2,
        attn_period=8,         # 1 attention layer per 8 (1:7 Mamba:attn)
        chunk_size=128,
    ),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    fsdp=True,
))
