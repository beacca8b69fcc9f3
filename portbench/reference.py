"""The plain reference of a DLRM configuration: sum-pooled lookups and the
click logits, in f32 with TF32 off, from the raw tables, MLP weights, dense
inputs and indices that the harness made.

It imports nothing of the program and takes nothing the program derived
from those inputs (no plan, packed buffer, cache rows or dedup ids).  The
one layout it must follow is the order of the interaction's pairs, frozen
here from ``src/repro_torch/models/dlrm.py::interact`` at commit b2230fa:
``torch.triu_indices(n, n, offset=1)``, the upper triangle row by row.
"""
from __future__ import annotations

import torch

__all__ = ["logits", "pairs", "pooled"]


def _plain_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def pairs(n: int) -> tuple[list[int], list[int]]:
    """The interaction's pairs ``(i, j)``, ``i < j < n``, row by row."""
    iu = [i for i in range(n) for _ in range(i + 1, n)]
    ju = [j for i in range(n) for j in range(i + 1, n)]
    return iu, ju


def pooled(tables: list[torch.Tensor], indices: torch.Tensor) -> torch.Tensor:
    """``(N, B, s)`` indices with ``-1`` padding -> ``(N, B, E)`` f32 sums of
    each bag's rows, table by table."""
    out = []
    for table, idx in zip(tables, indices):
        idx = idx.to(table.device).long()
        valid = idx >= 0
        rows = table[torch.where(valid, idx, 0)].float()
        out.append(torch.where(valid[..., None], rows, 0.0).sum(dim=1))
    return torch.stack(out)


def _mlp(layers: list[tuple[torch.Tensor, torch.Tensor]], x: torch.Tensor,
         final_relu: bool) -> torch.Tensor:
    for i, (w, b) in enumerate(layers):
        x = x @ w + b
        if i < len(layers) - 1 or final_relu:
            x = torch.relu(x)
    return x


def logits(mlp: dict, dense: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """The DLRM head over pooled ``emb`` (N, B, E): the bottom MLP (a ReLU
    after every layer) on ``dense``, the pairwise dot products of the
    ``N + 1`` vectors beside the bottom output, and the top MLP (no ReLU
    after the last layer) -> ``(B,)``.  ``mlp`` holds ``"bottom"`` and
    ``"top"`` as lists of ``(w (in, out), b)``."""
    _plain_f32()
    bot = _mlp(mlp["bottom"], dense.float(), final_relu=True)
    feats = torch.cat([bot[:, None], emb.float().transpose(0, 1)], dim=1)  # (B, N+1, E)
    gram = torch.bmm(feats, feats.transpose(1, 2))
    iu, ju = pairs(feats.shape[1])
    z = gram[:, torch.tensor(iu, device=gram.device), torch.tensor(ju, device=gram.device)]
    return _mlp(mlp["top"], torch.cat([bot, z], dim=-1), final_relu=False)[:, 0]
