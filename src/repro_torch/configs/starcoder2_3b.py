"""StarCoder2-3B [arXiv:2402.19173].

Dense decoder, GQA with 2 KV heads, RoPE, native sliding-window attention
(4096).  StarCoder2 uses LayerNorm + standard GeLU MLP (non-gated) per the
paper.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    source="arXiv:2402.19173",
    rope_theta=1e5,
    qkv_bias=True,
    attn_variant="sliding",
    sliding_window=4096,
    mlp_variant="gelu",
    norm_variant="layernorm",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
))
