"""DLRM (Deep Learning Recommendation Model) — the paper's model family.

Facebook-DLRM structure (Gupta et al., HPCA'20): dense features through a
bottom MLP, categorical features through embedding bags (sum-pooled), pairwise
dot-product feature interaction, top MLP to the CTR logit.

Two execution paths share the math:
* ``forward_dense``  — plain single-device lookups (tests);
* ``forward_packed`` — the paper's partitioned execution: embeddings come out
  of :func:`repro_torch.core.partition.partitioned_lookup` over a placement
  plan (the fused kernels on the card).

Serving parameters are ``{"tables": [(m_i, E) tensors], "bottom": MLP,
"top": MLP}``: the tables stay on the CPU for the engine to pack, and the
MLPs are ``nn.Linear`` stacks whose products are plain ``torch.matmul`` (the
JAX package leaves them to XLA).  :func:`params_from_jax` carries the JAX
package's parameters across.

Training works on the JAX package's own tree (:func:`train_params`):
``{"bottom": [{"b", "w" (in, out)}], "tables": [...], "top": [...]}``, every
leaf a plain tensor on the training device, so a leaf's number in an
optimizer state or a checkpoint is the JAX package's.
:func:`make_dlrm_train_step` differentiates :func:`forward_train`, the same
plain lookups as ``forward_dense``.
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
from repro_torch.tracing import span
from repro_torch.tree import value_and_grad

__all__ = [
    "DLRMConfig",
    "MLP",
    "bce_loss",
    "forward_dense",
    "forward_packed",
    "forward_train",
    "init_dlrm",
    "interact",
    "loss_fn",
    "make_dlrm_train_step",
    "params_from_jax",
    "train_params",
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


def _pooled(tables, indices, device) -> torch.Tensor:
    """Sum-pooled plain lookups, ``-1`` padding masked: (N, B, E)."""
    idx = torch.as_tensor(indices).to(device).long()
    outs = []
    for i, tab in enumerate(tables):
        tab = tab.to(device)
        valid = idx[i] >= 0
        g = tab[torch.where(valid, idx[i], 0)]
        outs.append(torch.where(valid[..., None], g, 0.0).sum(dim=1))
    return torch.stack(outs)


@torch.no_grad()
def forward_dense(cfg: DLRMConfig, params: Params, batch: dict) -> torch.Tensor:
    """batch: {"dense": (B, n_dense) f32, "indices": (N, B, s_max) int}."""
    x = batch["dense"]
    emb = _pooled(params["tables"], batch["indices"], x.device)  # (N, B, E)
    bot = params["bottom"](x)
    return params["top"](interact(bot, emb.to(bot.dtype)))[..., 0]  # (B,)


# --------------------------------------------------------------------------
# training (the JAX package's parameter tree)
# --------------------------------------------------------------------------


def train_params(params: Params, device="cpu") -> Params:
    """Serving parameters (:func:`init_dlrm`, :func:`params_from_jax`) as the
    JAX package's tree on ``device``, copied: ``{"bottom": [{"b", "w"}],
    "tables": [...], "top": [...]}`` with ``w`` (in, out)."""
    def mlp(m: MLP) -> list:
        return [{"b": l.bias.detach().to(device, copy=True),
                 "w": l.weight.detach().T.contiguous().to(device)} for l in m.layers]

    return {"bottom": mlp(params["bottom"]),
            "tables": [t.detach().to(device, copy=True) for t in params["tables"]],
            "top": mlp(params["top"])}


def _mlp_xw(layers: Sequence[dict], x: torch.Tensor, final_act: bool) -> torch.Tensor:
    for i, l in enumerate(layers):
        x = x @ l["w"].to(x.dtype) + l["b"].to(x.dtype)
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


def forward_train(cfg: DLRMConfig, params: Params, batch: dict) -> torch.Tensor:
    """``forward_dense`` on the tree of :func:`train_params`, differentiable
    in every leaf -> (B,) logits."""
    x = batch["dense"]
    emb = _pooled(params["tables"], batch["indices"], x.device)
    bot = _mlp_xw(params["bottom"], x, final_act=True)
    return _mlp_xw(params["top"], interact(bot, emb.to(bot.dtype)), final_act=False)[..., 0]


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on logits, in f32 (the stable form)."""
    z = logits.float()
    y = torch.as_tensor(labels).to(z.device).float()
    return torch.mean(torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-torch.abs(z))))


def loss_fn(cfg: DLRMConfig, params: Params, batch: dict) -> torch.Tensor:
    return bce_loss(forward_train(cfg, params, batch), batch["labels"])


def make_dlrm_train_step(cfg: DLRMConfig, optimizer):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss": ...})`` on :func:`train_params`' tree; the arguments are left
    as they are."""
    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(lambda p: loss_fn(cfg, p, batch), params)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss}

    return train_step


@torch.no_grad()
def forward_packed(
    cfg: DLRMConfig,
    bag: PartitionedEmbeddingBag,
    packed,
    mlp_params: Params,
    batch: dict,
    *,
    mesh=None,
    axis: str = "model",
    batch_axes: tuple[str, ...] = (),
    use_kernels="fused",
    reduce_mode: str = "sparse",
) -> torch.Tensor:
    """The paper's partitioned serving path (fused kernels + owner-sharded
    sparse rejoin by default) -> (B,) logits.  ``mesh``/``axis``/
    ``batch_axes`` run the lookup across cards (see
    :func:`repro_torch.core.partition.partitioned_lookup`); with
    ``batch_axes`` the logits are this rank's share of the batch."""
    emb = bag.apply(
        packed, batch["indices"], mesh=mesh, axis=axis, batch_axes=batch_axes,
        use_kernels=use_kernels, reduce_mode=reduce_mode,
    )  # (N, B, E) f32
    dense = batch["dense"]
    if mesh is not None and batch_axes:
        from repro_torch.core.partition import batch_share

        dense = batch_share(dense, mesh, batch_axes, dim=0)
    with span("step.bottom_mlp"):
        bot = mlp_params["bottom"](dense)
    with span("step.interact"):
        z = interact(bot, emb.to(bot.dtype))
    with span("step.top_mlp"):
        return mlp_params["top"](z)[..., 0]
