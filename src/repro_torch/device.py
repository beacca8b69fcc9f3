"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch

from repro_torch.tracing import count

__all__ = ["resolve_device", "to_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without a card raises (there
    is no silent CPU fallback — pass ``device="cpu"`` to run the plain
    versions).  Under a ``torch.distributed`` process group ``"cuda"`` (or
    ``None``) is this rank's own card, ``cuda:LOCAL_RANK``, and a rank with
    no card of its own raises.  Also pins full-f32 matmuls: TF32 off for
    cuBLAS and cuDNN, so the MLPs compute what the JAX package computes."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the card by default; "
                "pass device='cpu' to run the kernels' plain versions"
            )
        if dev.index is None and torch.distributed.is_available() \
                and torch.distributed.is_initialized():
            from repro_torch.launch.mesh import local_rank

            card = local_rank()
            if card >= torch.cuda.device_count():
                raise RuntimeError(
                    f"rank {torch.distributed.get_rank()} needs card {card} but "
                    f"only {torch.cuda.device_count()} are visible: start at "
                    "most one rank per card"
                )
            dev = torch.device("cuda", card)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def to_device(array, device: torch.device, *, counter: str | None = None) -> torch.Tensor:
    """``array`` (a numpy array, a tensor, or what ``torch.as_tensor``
    takes) as a tensor on ``device``, with its dtype, shape and values.

    A host array bound for a card goes through a page-locked buffer of its
    own shape: the host copies it in (``copy_``, over the intra-op
    threads), and the card reads it by an asynchronous copy on the current
    stream, so the host does not wait for the stream to drain as a copy
    from pageable memory does.  PyTorch's caching host allocator hands the
    buffer out again only once that copy has completed, and ``array`` is
    not read after the return: the caller may overwrite it at once.  The
    allocator keeps its blocks for the life of the process, one for each
    size asked for (rounded up to a power of two) and in use at once.
    Anything else goes through ``torch.as_tensor``: a tensor already on
    ``device`` comes back as it is, and a CPU device takes a numpy array
    without a copy where it can.

    ``counter``: a :func:`repro_torch.tracing.count` counter that the bytes
    staged are added to (0 where nothing was staged)."""
    device = torch.device(device)
    staged = device.type == "cuda" and (
        not isinstance(array, torch.Tensor) or array.device.type == "cpu")
    if staged:
        host = torch.as_tensor(array)
        out = torch.empty_like(host, pin_memory=True).copy_(host).to(device, non_blocking=True)
    else:
        out = torch.as_tensor(array, device=device)
    if counter is not None:
        count(counter, out.numel() * out.element_size() if staged else 0)
    return out
