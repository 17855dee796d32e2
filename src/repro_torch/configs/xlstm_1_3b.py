"""xLSTM-1.3B [arXiv:2405.04517].

48 residual blocks alternating mLSTM (matrix memory, chunkwise-parallel)
and sLSTM (scalar memory, sequential scan) at a 1-per-4 sLSTM ratio
(xLSTM[7:1]-style).  d_ff=0: xLSTM blocks carry their own up/down
projections, there is no separate FFN.  Recurrent state => long_500k runs
with O(1) per-step memory.  A full forward (and so a prefill) needs a
sequence length that is a multiple of ``chunk_size`` (or shorter than it).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    source="arXiv:2405.04517",
    ssm=SSMConfig(
        variant="xlstm",
        xlstm_slstm_ratio=4,   # 1 sLSTM per 4 blocks
        chunk_size=64,
    ),
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
))
