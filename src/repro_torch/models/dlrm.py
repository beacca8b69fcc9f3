"""DLRM (Deep Learning Recommendation Model) — the paper's model family.

Facebook-DLRM structure (Gupta et al., HPCA'20): dense features through a
bottom MLP, categorical features through embedding bags (sum-pooled), pairwise
dot-product feature interaction, top MLP to the CTR logit.

Two execution paths share the math:
* ``forward_dense``  — plain single-device lookups (tests);
* ``forward_packed`` — the paper's partitioned execution: embeddings come out
  of :func:`repro_torch.core.partition.partitioned_lookup` over a placement
  plan (the fused kernels on the card).

Parameters are ``{"tables": [(m_i, E) tensors], "bottom": MLP, "top": MLP}``;
the MLPs are ``nn.Linear`` stacks whose products are plain ``torch.matmul``
(the JAX package leaves them to XLA).  :func:`params_from_jax` carries the
JAX package's parameters across.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.core.embedding import PartitionedEmbeddingBag
from repro_torch.core.tables import Workload
from repro_torch.models.layers import dense_init

__all__ = [
    "DLRMConfig",
    "MLP",
    "forward_dense",
    "forward_packed",
    "init_dlrm",
    "interact",
    "params_from_jax",
]

Params = dict


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    arch: str
    workload: Workload
    n_dense: int = 13
    embed_dim: int = 16
    bottom_mlp: tuple[int, ...] = (512, 256, 64)
    top_mlp: tuple[int, ...] = (512, 256)
    family: str = "dlrm"

    @property
    def n_tables(self) -> int:
        return len(self.workload.tables)

    @property
    def bottom_dims(self) -> list[int]:
        return [self.n_dense, *self.bottom_mlp, self.embed_dim]

    @property
    def top_dims(self) -> list[int]:
        n_int = self.n_tables + 1
        return [self.embed_dim + n_int * (n_int - 1) // 2, *self.top_mlp, 1]

    def param_count(self) -> int:
        n = sum(t.rows * t.dim for t in self.workload.tables)
        for dims in (self.bottom_dims, self.top_dims):
            n += sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        return n


class MLP(nn.Module):
    """``nn.Linear`` stack with ReLU between layers (and after the last one
    when ``final_act``)."""

    def __init__(self, dims: Sequence[int], final_act: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])
        )
        self.final_act = final_act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1 or self.final_act:
                x = torch.relu(x)
        return x

    @torch.no_grad()
    def load_xw(self, layers: Sequence[dict]) -> "MLP":
        """Load layers given as ``x @ w + b`` with ``w`` (in, out): nn.Linear
        stores ``(out, in)``, so ``w`` is transposed."""
        if len(layers) != len(self.layers):
            raise ValueError(f"expected {len(self.layers)} layers, got {len(layers)}")
        for lin, l in zip(self.layers, layers):
            w = torch.tensor(np.asarray(l["w"]), dtype=torch.float32)
            b = torch.tensor(np.asarray(l["b"]), dtype=torch.float32)
            if tuple(w.shape) != (lin.in_features, lin.out_features):
                raise ValueError(
                    f"w must be (in, out) = ({lin.in_features}, "
                    f"{lin.out_features}), got {tuple(w.shape)}"
                )
            lin.weight.copy_(w.T)
            lin.bias.copy_(b)
        return self


def _mlp_init(generator, dims: Sequence[int], final_act: bool) -> MLP:
    return MLP(dims, final_act).load_xw([
        {"w": dense_init(generator, (a, b)), "b": torch.zeros(b)}
        for a, b in zip(dims[:-1], dims[1:])
    ])


def init_dlrm(
    cfg: DLRMConfig, generator: torch.Generator | None = None, device="cpu"
) -> Params:
    """Fresh parameters from ``generator``: N(0, 1/E) tables (kept on the
    CPU: the engine packs them onto the device) and truncated-normal MLPs
    on ``device``."""
    tables = [
        torch.randn((t.rows, t.dim), generator=generator) / float(np.sqrt(t.dim))
        for t in cfg.workload.tables
    ]
    bottom = _mlp_init(generator, cfg.bottom_dims, final_act=True)
    top = _mlp_init(generator, cfg.top_dims, final_act=False)
    return {"tables": tables, "bottom": bottom.to(device), "top": top.to(device)}


def params_from_jax(cfg: DLRMConfig, params_np: dict, device="cpu") -> Params:
    """The JAX package's ``init_dlrm`` parameters, as numpy arrays, in the
    port's form: tables unchanged (CPU tensors), each ``{"w": (in, out),
    "b": (out,)}`` MLP layer loaded into ``nn.Linear`` (weights transposed)."""
    return {
        "tables": [torch.tensor(np.asarray(t)) for t in params_np["tables"]],
        "bottom": MLP(cfg.bottom_dims, final_act=True).load_xw(params_np["bottom"]).to(device),
        "top": MLP(cfg.top_dims, final_act=False).load_xw(params_np["top"]).to(device),
    }


def interact(bottom_out: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Pairwise dot interaction. bottom_out (B, E), emb (N, B, E) -> (B, F)."""
    feats = torch.cat([bottom_out[None], emb], dim=0).transpose(0, 1)  # (B, N+1, E)
    z = torch.bmm(feats, feats.transpose(1, 2))  # (B, N+1, N+1)
    n = feats.shape[1]
    iu, ju = torch.triu_indices(n, n, offset=1, device=feats.device)
    return torch.cat([bottom_out, z[:, iu, ju]], dim=-1)


@torch.no_grad()
def forward_dense(cfg: DLRMConfig, params: Params, batch: dict) -> torch.Tensor:
    """batch: {"dense": (B, n_dense) f32, "indices": (N, B, s_max) int}."""
    x = batch["dense"]
    idx = torch.as_tensor(batch["indices"]).to(x.device).long()
    outs = []
    for i, tab in enumerate(params["tables"]):
        tab = tab.to(x.device)
        valid = idx[i] >= 0
        g = tab[torch.where(valid, idx[i], 0)]
        outs.append(torch.where(valid[..., None], g, 0.0).sum(dim=1))
    emb = torch.stack(outs)  # (N, B, E)
    bot = params["bottom"](x)
    return params["top"](interact(bot, emb.to(bot.dtype)))[..., 0]  # (B,)


@torch.no_grad()
def forward_packed(
    cfg: DLRMConfig,
    bag: PartitionedEmbeddingBag,
    packed,
    mlp_params: Params,
    batch: dict,
    *,
    use_kernels="fused",
    reduce_mode: str = "sparse",
) -> torch.Tensor:
    """The paper's partitioned serving path (fused kernels + owner-sharded
    sparse rejoin by default) -> (B,) logits."""
    emb = bag.apply(
        packed, batch["indices"], use_kernels=use_kernels, reduce_mode=reduce_mode,
    )  # (N, B, E) f32
    bot = mlp_params["bottom"](batch["dense"])
    return mlp_params["top"](interact(bot, emb.to(bot.dtype)))[..., 0]
