"""Gemma-2B [arXiv:2403.08295].

GeGLU MLP, head_dim=256, MQA (num_kv_heads=1), tied embeddings, RMSNorm.
long_500k uses the sliding-window serving variant (beyond-paper; DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    source="arXiv:2403.08295",
    rope_theta=1e4,
    mlp_variant="geglu",
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
))
