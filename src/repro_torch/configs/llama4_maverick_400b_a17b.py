"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E] (port of
``repro/configs/llama4_maverick_400b_a17b.py``).

MoE with 128 routed experts, top-1 routing + 1 shared expert, interleaved
MoE/dense layers (period 2, MoE first), GQA kv=8; the text backbone of an
early-fusion multimodal model.  Llama-4 uses chunked/sliding attention on
most layers; the config uses the sliding variant throughout.
"""
from repro_torch.configs.base import MoEConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,             # dense-layer FFN width
    vocab_size=202048,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    rope_theta=5e5,
    attn_variant="sliding",
    sliding_window=8192,
    mlp_variant="swiglu",
    moe=MoEConfig(
        num_experts=128,
        top_k=1,
        d_ff_expert=8192,
        num_shared_experts=1,
        layer_period=2,        # every other layer is MoE (interleaved)
        first_dense_layers=0,
    ),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    fsdp=True,
))
