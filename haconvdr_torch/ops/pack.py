"""Packing a batch of right-padded rows for an inference forward of the
tower: the token-wise layers (embeddings, denses, GELU, LayerNorms,
residual adds, the int8 codes) run on the ``T`` packed rows that can
affect the output, and attention on the batch trimmed to its longest row.

The plan is made on the host from the mask: row b keeps its span
``[0, e_b)``, ``e_b`` its last mask-one position + 1 (a row with no
mask-one position keeps position 0, which CLS pooling reads).  Interior
masked positions stay in the span and stay masked as keys.  The packed
layout puts the rows' spans one after the other; attention runs on a
``[B, width]`` buffer, ``width`` the longest span rounded up to a multiple
of ``ALIGN`` (at most the batch's width), into which the packed rows are
scattered and out of which the context is gathered (``scatter`` /
``gather``).

``COUNTS`` (read with every ``ops.*`` module's by
``utils.telemetry.read_counters``): ``forwards`` packed forwards,
``slots`` the ``B x L`` of their batches as they arrived, ``rows`` the
``T`` the token-wise layers ran, ``valid`` the masks' ones, and
``plan_reads`` the plans made by reading a mask tensor because the caller
passed no host mask (one host sync each on the card).
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

COUNTS = {"forwards": 0, "slots": 0, "rows": 0, "valid": 0, "plan_reads": 0}
ALIGN = 16  # attention's width is a multiple of this (or the batch's own)


class Plan:
    """One batch's packing, from its host mask ``[B, L]``:

    * ``lengths`` [B]: each row's kept span ``[0, e_b)``;
    * ``width``: attention's trimmed width;
    * ``rows``: ``T``, the packed rows;
    * ``index``: int64 [T + B], the kept positions' flat indices into
      ``[B, width]`` (row by row), then each row's first packed row.

    Making one counts a forward in ``COUNTS``."""

    def __init__(self, mask: np.ndarray):
        mask = np.asarray(mask)
        if mask.ndim != 2 or mask.shape[1] == 0:
            raise ValueError(f"a mask must be [B, L] with L >= 1, got {mask.shape}")
        B, L = mask.shape
        nz = mask != 0
        last = L - np.argmax(nz[:, ::-1], axis=1)
        self.lengths = np.where(nz.any(axis=1), last, 1).astype(np.int64)
        self.width = min(L, -(-int(self.lengths.max()) // ALIGN) * ALIGN)
        starts = np.zeros(B + 1, np.int64)
        np.cumsum(self.lengths, out=starts[1:])
        self.rows = int(starts[-1])
        row = np.repeat(np.arange(B, dtype=np.int64), self.lengths)
        kept = row * self.width + (np.arange(self.rows, dtype=np.int64) - starts[row])
        self.index = np.concatenate([kept, starts[:-1]])
        COUNTS["forwards"] += 1
        COUNTS["slots"] += B * L
        COUNTS["rows"] += self.rows
        COUNTS["valid"] += int(nz.sum())

    def to(self, device: torch.device):
        """(kept [T], starts [B]) int64 on ``device``: on the card one copy
        from pinned memory that does not block the host."""
        t = torch.from_numpy(self.index)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        return t[: self.rows], t[self.rows :]


def plan_of(attention_mask: torch.Tensor, host_mask=None) -> Plan:
    """The plan of a batch: from ``host_mask`` (numpy, the mask the caller
    holds on the host), else read from ``attention_mask`` (counted in
    ``plan_reads``)."""
    if host_mask is None:
        COUNTS["plan_reads"] += 1
        host_mask = attention_mask.cpu().numpy()
    elif tuple(np.shape(host_mask)) != tuple(attention_mask.shape):
        raise ValueError(f"host_mask {np.shape(host_mask)} is not the mask's "
                         f"{tuple(attention_mask.shape)}")
    return Plan(host_mask)


def _words(t: torch.Tensor) -> torch.Tensor:
    """The rows of ``t`` (dim >= 2) viewed as 8-byte words where their bytes
    allow (the index kernels move one element a thread: a bf16 row of 768
    moves as 192 words, not 768 halves), else ``t``."""
    n = t.shape[-1] * t.element_size()
    if t.dim() > 1 and t.element_size() < 8 and n % 8 == 0 and t.stride(-1) == 1:
        return t.view(torch.int64)
    return t


def scatter(buf: torch.Tensor, kept: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Packed rows ``x`` [T, C] into their positions of ``buf``
    [B * width, C] (the bytes moved as they are); the positions outside
    the spans keep what they hold."""
    _words(buf).index_copy_(0, kept, _words(x.contiguous()))
    return buf


def gather(x: torch.Tensor, kept: torch.Tensor) -> torch.Tensor:
    """The kept positions of ``x`` [B, width, ...]: [T, ...]."""
    x = x.flatten(0, 1).contiguous()
    return _words(x).index_select(0, kept).view(x.dtype)


def takes_host_mask(fn) -> bool:
    """Whether ``fn`` (a module: its ``forward``) takes the ``host_mask``
    keyword, by name or through ``**kwargs``."""
    target = fn.forward if isinstance(fn, torch.nn.Module) else fn
    try:
        params = inspect.signature(target).parameters.values()
    except (TypeError, ValueError):
        return False
    return any(p.name == "host_mask" or p.kind is p.VAR_KEYWORD for p in params)
