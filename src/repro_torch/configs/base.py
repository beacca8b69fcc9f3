"""Architecture + shape configuration dataclasses.

Every assigned architecture gets one ``configs/<id>.py`` exporting ``CONFIG``
(exact published dims) and ``SMOKE`` (a reduced same-family config for CPU
smoke tests).  Shapes are global (assignment spec): train_4k / prefill_32k /
decode_32k / long_500k, each paired with per-arch applicability rules.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.models.mamba2 import MambaSpec
from repro_torch.models.moe import MoESpec

VOCAB_PAD = 256  # vocab padded to a multiple (sharding divisibility)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | dlrm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab: int = 0
    # variants
    norm: str = "rms"  # rms | ln | ln_nonparam
    mlp: str = "swiglu"  # swiglu | gelu
    rope: str | None = "std"  # std | partial | mrope | None(learned/sinusoidal)
    rope_base: float = 10000.0
    rotary_frac: float = 1.0
    mrope_sections: tuple[int, ...] | None = None
    qk_norm: bool = False
    window: int | None = None  # sliding-window attention
    moe: MoESpec | None = None
    ssm: MambaSpec | None = None
    shared_attn_every: int = 0  # zamba2-style shared block cadence
    enc_layers: int = 0  # whisper encoder depth
    input_kind: str = "tokens"  # tokens | embeds | frames_tokens
    max_target_positions: int = 32768  # learned positional table (encdec)
    # execution knobs
    compute_dtype: str = "bfloat16"  # activations; params stay fp32 for train
    seq_parallel: bool = False  # shard residual-stream seq dim over "model" (train)
    low_precision_opt: bool = False  # bf16 adam moments + bf16 grad accumulation
    attn_block: int = 1024  # kv chunk
    q_chunk: int = 1024  # query chunk for long prefill
    grad_accum: dict[str, int] = dataclasses.field(default_factory=dict)
    serve_microbatch: dict[str, int] = dataclasses.field(default_factory=dict)
    source: str = ""  # provenance note

    @property
    def vocab_padded(self) -> int:
        return int(-(-self.vocab // VOCAB_PAD) * VOCAB_PAD)

    def supports(self, shape_name: str) -> bool:
        s = SHAPES[shape_name]
        if s.kind == "decode" and self.family == "dlrm":
            return False
        if shape_name == "long_500k":
            # needs sub-quadratic attention: SSM/hybrid, or SWA-bounded cache.
            return self.family in ("ssm", "hybrid") or self.window is not None
        return True

    def param_count(self) -> int:
        """Analytic parameter count (unpadded vocab)."""
        d, l = self.d_model, self.n_layers
        n = 0
        if self.vocab:
            n += self.vocab * d * 2  # embed + untied head
        hd = self.n_heads * self.head_dim
        kvd = self.n_kv_heads * self.head_dim
        attn = d * hd + 2 * d * kvd + hd * d
        if self.family == "ssm":
            sp = self.ssm
            per = (
                d * (2 * sp.d_inner + 2 * sp.n_groups * sp.d_state + sp.n_heads)
                + sp.d_conv * (sp.d_inner + 2 * sp.n_groups * sp.d_state)
                + sp.d_inner * d
            )
            n += l * per
        elif self.family == "hybrid":
            sp = self.ssm
            per = (
                d * (2 * sp.d_inner + 2 * sp.n_groups * sp.d_state + sp.n_heads)
                + sp.d_conv * (sp.d_inner + 2 * sp.n_groups * sp.d_state)
                + sp.d_inner * d
            )
            n += l * per
            # one shared block at width 2d
            d2 = 2 * d
            n += d2 * hd + 2 * d2 * kvd + hd * d2 + 3 * d2 * self.d_ff + d2 * d
        elif self.moe is not None:
            ffn = self.moe.n_experts * 3 * d * self.moe.d_ff + d * self.moe.n_experts
            n += l * (attn + ffn)
        else:
            ffn = (3 if self.mlp == "swiglu" else 2) * d * self.d_ff
            n += (l + self.enc_layers) * (attn + ffn)
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if self.moe is None:
            return self.param_count()
        d, l = self.d_model, self.n_layers
        hd = self.n_heads * self.head_dim
        kvd = self.n_kv_heads * self.head_dim
        attn = d * hd + 2 * d * kvd + hd * d
        ffn = self.moe.top_k * 3 * d * self.moe.d_ff + d * self.moe.n_experts
        return self.vocab * d * 2 + l * (attn + ffn)


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    kind: str  # train | prefill | decode
    seq: int
    batch: int


SHAPES: dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCfg("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCfg("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCfg("long_500k", "decode", 524288, 1),
}

# smoke-test shapes (reduced, CPU)
SMOKE_SHAPE = ShapeCfg("smoke", "train", 64, 2)


def flops_per_token(cfg: ArchConfig, seq: int, kind: str) -> float:
    """Analytic MODEL_FLOPS per token: 6*N_active (train) or 2*N_active
    (inference) for the matmul path + attention-score/AV terms."""
    n_active = cfg.active_param_count()
    mult = 6.0 if kind == "train" else 2.0
    f = mult * n_active
    if cfg.n_heads and cfg.family != "ssm":
        # qk^T + pv: 2 * 2 * S_kv * H * dh per token (x3 for train bwd)
        causal_avg = 0.5 if kind != "decode" else 1.0
        attn = 4.0 * seq * cfg.n_heads * cfg.head_dim * causal_avg
        layers = cfg.n_layers + cfg.enc_layers
        if cfg.family == "hybrid":
            layers = max(cfg.n_layers // max(cfg.shared_attn_every, 1), 1)
        if cfg.window is not None and kind != "train":
            attn = 4.0 * min(seq, cfg.window) * cfg.n_heads * cfg.head_dim
        f += (3.0 if kind == "train" else 1.0) * attn * layers
    return f
