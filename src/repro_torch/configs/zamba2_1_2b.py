"""zamba2-1.2b: 38 Mamba2 layers d2048 (ssm_state=64) + a SHARED attention
block (32H MHA, kv=32) invoked every 6 layers on concat(hidden, embedding)
at width 2d, ff8192, vocab 32000. [arXiv:2411.15242; hf Zyphra/Zamba2-1.2B]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.mamba2 import MambaSpec

CONFIG = ArchConfig(
    arch="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,  # shared block operates at width 2d=4096 = 32*128
    d_ff=8192,
    vocab=32000,
    norm="rms",
    mlp="swiglu",
    rope="std",
    shared_attn_every=6,
    ssm=MambaSpec(
        d_model=2048, d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256
    ),
    grad_accum={"train_4k": 4},
    source="arXiv:2411.15242",
)

SMOKE = ArchConfig(
    compute_dtype="float32",
    arch="zamba2-smoke",
    family="hybrid",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,  # 2d=128 = 4*32
    d_ff=128,
    vocab=512,
    norm="rms",
    mlp="swiglu",
    rope="std",
    shared_attn_every=2,
    ssm=MambaSpec(d_model=64, d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16),
    attn_block=32,
    q_chunk=64,
)
