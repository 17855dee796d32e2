"""DeepSeek-V2-Lite (16B total / 2.4B active) [arXiv:2405.04434].

MLA attention with kv_lora_rank=512 (compressed KV cache), MoE FFN with
shared experts, first layer dense.  The reference follows its assignment's
spec line: 64 routed experts, top-6, plus 2 shared experts,
d_ff_expert=1408 (the full V2 has 160 routed experts).
"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=10944,            # dense first layer FFN (V2-Lite)
    vocab_size=102400,
    source="arXiv:2405.04434",
    rope_theta=1e4,
    mlp_variant="swiglu",
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        d_ff_expert=1408,
        num_shared_experts=2,
        layer_period=1,
        first_dense_layers=1,
    ),
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=0,
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
    ),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    fsdp=True,
))
