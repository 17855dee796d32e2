"""HuBERT X-Large [arXiv:2106.07447] (port of ``repro/configs/hubert_xlarge.py``).

Encoder-only (bidirectional) transformer, the wav2vec 2.0 backbone; vocab
504 is the masked-prediction codebook size.  The convolutional waveform
feature extractor is not modelled: batches carry precomputed frame
embeddings (B, S, frontend_dim), and the model owns the feature projection,
the transformer and the prediction head.  Encoder-only, so it has no
decode and is never served.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    source="arXiv:2106.07447",
    causal=False,
    mlp_variant="gelu",
    norm_variant="layernorm",
    frontend_dim=512,          # conv feature-extractor output dim (stubbed)
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
))
