"""Qwen2.5-14B [hf:Qwen/Qwen2.5-0.5B family].

Dense decoder, GQA kv=8 with QKV bias, SwiGLU, RMSNorm, huge vocab.
long_500k uses the sliding-window serving variant (DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    source="hf:Qwen/Qwen2.5-0.5B",
    rope_theta=1e6,
    qkv_bias=True,
    mlp_variant="swiglu",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    fsdp=True,
))
