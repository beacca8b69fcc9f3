"""granite-moe-3b-a800m: 32L d1536 24H (GQA kv=8, head_dim 64) vocab 49155,
MoE 40 experts top-8 with d_ff 512/expert.  The assignment line lists both
"40e" and "32 experts"; we follow the 40-expert count that matches the
published granite-3.0-3b-a800m dims (d1536/ff512).
[hf ibm-granite/granite-3.0-3b-a800m-base]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.moe import MoESpec

# the JAX package's MoESpec also sets virtual_factor=2, an expert-parallel
# knob that splits experts over a device mesh; the port's spec has none

CONFIG = ArchConfig(
    arch="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    norm="rms",
    mlp="swiglu",
    rope="std",
    moe=MoESpec(n_experts=40, top_k=8, d_ff=512, capacity_factor=1.25, group_size=256),
    seq_parallel=True,
    low_precision_opt=True,
    serve_microbatch={"prefill_32k": 2},
    grad_accum={"train_4k": 8},
    source="hf:ibm-granite/granite-3.0-3b-a800m-base",
)

SMOKE = ArchConfig(
    compute_dtype="float32",
    arch="granite-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab=512,
    norm="rms",
    mlp="swiglu",
    rope="std",
    moe=MoESpec(n_experts=8, top_k=2, d_ff=32, capacity_factor=1.5),
    attn_block=32,
    q_chunk=64,
)
