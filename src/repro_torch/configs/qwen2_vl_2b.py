"""qwen2-vl-2b: 28L d1536 12H (GQA kv=2) ff8960 vocab 151936 — M-RoPE,
dynamic-resolution vision frontend STUBBED (input_specs provides precomputed
patch embeddings). [arXiv:2409.12191; hf Qwen/Qwen2-VL-2B]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab=151936,
    norm="rms",
    mlp="swiglu",
    rope="mrope",
    rope_base=1_000_000.0,
    mrope_sections=(16, 24, 24),  # sums to head_dim/2
    input_kind="embeds",
    seq_parallel=True,
    grad_accum={"train_4k": 4},
    source="arXiv:2409.12191",
)

SMOKE = ArchConfig(
    compute_dtype="float32",
    arch="qwen2-vl-2b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    norm="rms",
    mlp="swiglu",
    rope="mrope",
    mrope_sections=(2, 3, 3),
    input_kind="embeds",
    attn_block=32,
    q_chunk=64,
)
