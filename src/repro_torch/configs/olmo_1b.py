"""olmo-1b: 16L d2048 16H (kv=16) ff8192 vocab 50304 — non-parametric LN.
[arXiv:2402.00838; hf allenai/OLMo-1B]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab=50304,
    norm="ln_nonparam",
    mlp="swiglu",
    rope="std",
    grad_accum={"train_4k": 2},
    source="arXiv:2402.00838",
)

SMOKE = ArchConfig(
    compute_dtype="float32",
    arch="olmo-1b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=512,
    norm="ln_nonparam",
    mlp="swiglu",
    rope="std",
    attn_block=32,
    q_chunk=64,
)
