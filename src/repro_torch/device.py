"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without a card raises (there
    is no silent CPU fallback — pass ``device="cpu"`` to run the plain
    versions).  Also pins full-f32 matmuls: TF32 off for cuBLAS and cuDNN,
    so the MLPs compute what the JAX package computes."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the card by default; "
                "pass device='cpu' to run the kernels' plain versions"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
