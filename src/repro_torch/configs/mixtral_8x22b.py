"""mixtral-8x22b: 56L d6144 48H (GQA kv=8) ff16384 vocab 32768, MoE 8 experts
top-2, sliding-window attention (4096) per the assignment.
[arXiv:2401.04088; hf mistralai/Mixtral-8x22B]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.moe import MoESpec

# the JAX package's MoESpec also sets virtual_factor=2, an expert-parallel
# knob that splits experts over a device mesh; the port's spec has none

CONFIG = ArchConfig(
    arch="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=32768,
    norm="rms",
    mlp="swiglu",
    rope="std",
    rope_base=1_000_000.0,
    window=4096,
    moe=MoESpec(n_experts=8, top_k=2, d_ff=16384, capacity_factor=1.25, group_size=1024),
    seq_parallel=True,
    low_precision_opt=True,
    serve_microbatch={"prefill_32k": 2},
    grad_accum={"train_4k": 16},
    attn_block=2048,
    q_chunk=4096,
    source="arXiv:2401.04088",
)

SMOKE = ArchConfig(
    compute_dtype="float32",
    arch="mixtral-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab=512,
    norm="rms",
    mlp="swiglu",
    rope="std",
    window=32,
    moe=MoESpec(n_experts=4, top_k=2, d_ff=96, capacity_factor=1.5),
    attn_block=16,
    q_chunk=32,
)
