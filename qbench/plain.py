"""Plain torch helpers the references share: grouped sums by an index, and
the strings of a dictionary's groups. No kernel and nothing of the port."""

from __future__ import annotations

import numpy as np
import torch

from qbench.data import Column, strings


def group_sum(index: torch.Tensor, values: torch.Tensor, size: int,
              dtype) -> torch.Tensor:
    """Per-group sums of ``values`` in ``dtype`` (an integer dtype sums
    exactly)."""
    out = torch.zeros(size, dtype=dtype, device=values.device)
    return out.index_add_(0, index, values.to(dtype))


def present(index: torch.Tensor, size: int) -> tuple:
    """(the groups with at least one row, as a long tensor; the rows a
    group)."""
    count = torch.bincount(index, minlength=size)
    return torch.nonzero(count).squeeze(1), count


def host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def floats(t: torch.Tensor) -> np.ndarray:
    """A result column of floats, on the host, as float64."""
    return host(t.to(torch.float64))


def dict_strings(col: Column, codes: torch.Tensor) -> np.ndarray:
    """The strings of a dict column at ``codes``."""
    return strings(col.offsets, col.pool, codes)


def dict_size(col: Column) -> int:
    return int(col.offsets.numel()) - 1
