"""qwen3-0.6b: 28L d1024 16H (GQA kv=8, head_dim 128) ff3072 vocab 151936 —
qk_norm. [hf Qwen/Qwen3-0.6B family; arXiv:2505.09388]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab=151936,
    norm="rms",
    mlp="swiglu",
    rope="std",
    rope_base=1_000_000.0,
    qk_norm=True,
    grad_accum={"train_4k": 4},
    source="hf:Qwen/Qwen3-0.6B",
)

SMOKE = ArchConfig(
    compute_dtype="float32",
    arch="qwen3-0.6b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    norm="rms",
    mlp="swiglu",
    rope="std",
    qk_norm=True,
    attn_block=32,
    q_chunk=64,
)
