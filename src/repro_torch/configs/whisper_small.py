"""whisper-small: enc-dec 12L+12L d768 12H ff3072 vocab 51865 — conv audio
frontend STUBBED (input_specs provides precomputed frame embeddings); GELU
MLPs, parametric LN, learned decoder positions, sinusoidal encoder positions.
[arXiv:2212.04356]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch="whisper-small",
    family="encdec",
    n_layers=12,
    enc_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab=51865,
    norm="ln",
    mlp="gelu",
    rope=None,
    max_target_positions=32768,  # sized for decode_32k (real model: 448)
    seq_parallel=True,
    grad_accum={"train_4k": 2},
    source="arXiv:2212.04356",
)

SMOKE = ArchConfig(
    compute_dtype="float32",
    arch="whisper-small-smoke",
    family="encdec",
    n_layers=2,
    enc_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=512,
    norm="ln",
    mlp="gelu",
    rope=None,
    max_target_positions=128,
    attn_block=32,
    q_chunk=64,
)
