"""chatglm3-6b: 28L d4096 32H (GQA kv=2) ff13696 vocab 65024 — partial ("2d")
RoPE over half the head dim. [arXiv:2406.12793; hf THUDM/chatglm3-6b]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab=65024,
    norm="rms",
    mlp="swiglu",
    rope="partial",
    rotary_frac=0.5,
    grad_accum={"train_4k": 8},
    source="arXiv:2406.12793",
)

SMOKE = ArchConfig(
    compute_dtype="float32",
    arch="chatglm3-6b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    head_dim=8,
    d_ff=160,
    vocab=512,
    norm="rms",
    mlp="swiglu",
    rope="partial",
    rotary_frac=0.5,
    attn_block=32,
    q_chunk=64,
)
