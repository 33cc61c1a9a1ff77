"""Device and dtype helpers (single-device counterpart of
haconvdr_tpu/parallel/mesh.py).

Importing this module pins float32 matmul precision: TF32 is off for
both cuBLAS and cuDNN, so a float32 product on the card is a float32
product, as on the CPU and as in the JAX reference (HIGHEST precision).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Union[str, torch.device, None]

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def resolve_device(name: DeviceLike = None) -> torch.device:
    """``None`` -> the CUDA card: the port's entry points run there unless
    the caller names the CPU (``"cpu"``).  A CUDA device without a card
    raises instead of quietly running on the CPU."""
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False"
        )
    return dev


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """``ModelConfig.dtype`` / ``store_dtype`` string -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(
            f"unsupported dtype {name!r}; expected one of {sorted(_DTYPES)}"
        ) from None


def to_torch(x, device: DeviceLike, dtype=None) -> torch.Tensor:
    """numpy array / tensor -> tensor on ``device``.  numpy bfloat16
    (ml_dtypes, as EmbeddingBlockStore reads it) goes through its raw
    uint16 bits."""
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        t = x
    else:
        a = np.asarray(x)
        if not a.flags.writeable:  # e.g. an mmap'd store block
            a = a.copy()
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
                torch.bfloat16
            )
        else:
            t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    return t.to(dev)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy (bfloat16 widens to float32: numpy has none)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
