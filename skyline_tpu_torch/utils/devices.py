"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def device_type(device) -> str:
    """The type of ``device`` — a torch.device or a name such as
    ``"cuda:0"`` — as ``"cuda"`` or ``"cpu"``."""
    return str(getattr(device, "type", device)).split(":", 1)[0]


def upload_async(arr, device: torch.device) -> torch.Tensor:
    """A host numpy array on ``device`` without waiting for the card: a
    pinned copy queued on the current stream, so host work overlaps the
    kernels in flight (a pageable copy would wait for them). On the CPU,
    the array's tensor."""
    t = torch.from_numpy(arr)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def resolve_device(device) -> torch.device:
    """The port's entry points run on CUDA unless the caller asks for the
    CPU. A CUDA device without a card raises instead of carrying on
    somewhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
