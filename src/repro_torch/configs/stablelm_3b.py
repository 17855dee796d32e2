"""StableLM-3B [hf:stabilityai/stablelm-2-1_6b family].

Dense decoder, MHA (kv=32 == heads), SwiGLU, LayerNorm, partial rotary.
long_500k uses the sliding-window serving variant (DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    source="hf:stabilityai/stablelm-2-1_6b",
    rope_theta=1e4,
    mlp_variant="swiglu",
    norm_variant="layernorm",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
))
