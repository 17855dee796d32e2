"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf]
(port of ``repro/configs/llava_next_mistral_7b.py``).

The language model is Mistral-7B (GQA kv=8, SwiGLU, RMSNorm).  The anyres
ViT tower is not modelled: batches carry precomputed patch embeddings
(B, P, frontend_dim), which the model projects through its two-layer
frontend and splices over the first P token positions.
num_prefix_embeds=2880 is about the anyres budget of 5 tiles × 576 patches.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    rope_theta=1e6,
    mlp_variant="swiglu",
    frontend_dim=1024,         # CLIP-ViT-L patch embedding dim (stubbed)
    num_prefix_embeds=2880,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
))
