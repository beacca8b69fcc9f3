"""mamba2-780m: 48L d1536 attention-free SSD, ssm_state=128, vocab 50280.
[arXiv:2405.21060; hf state-spaces/mamba2-780m]"""
from repro_torch.configs.base import ArchConfig
from repro_torch.models.mamba2 import MambaSpec

CONFIG = ArchConfig(
    arch="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    vocab=50280,
    norm="rms",
    ssm=MambaSpec(
        d_model=1536, d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256
    ),
    grad_accum={"train_4k": 4},
    source="arXiv:2405.21060",
)

SMOKE = ArchConfig(
    compute_dtype="float32",
    arch="mamba2-780m-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    vocab=512,
    norm="rms",
    ssm=MambaSpec(d_model=64, d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16),
)
