"""The raw columns a generator makes, and the helpers both sides share.

A generator returns ``{table: {column: Column}}`` of plain torch tensors on
the run's device. The staging (``stage.py``) wraps them into the port's
Tables without copying; the references read the same tensors. Nothing here
imports the port.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

# column kinds: fixed-width values, a date (int32 days since 1970-01-01), or
# a dictionary<int32, utf8> (int32 codes into ``offsets`` / ``pool``)
KINDS = ("int32", "int64", "float64", "date32", "dict")


@dataclass
class Column:
    kind: str
    values: torch.Tensor
    offsets: Optional[torch.Tensor] = None   # a dictionary's strings
    pool: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown column kind {self.kind!r}")
        if (self.kind == "dict") != (self.offsets is not None):
            raise ValueError("a dict column, and only one, has strings")

    @property
    def rows(self) -> int:
        return int(self.values.shape[0])


def stream(seed: int, *names: str, device) -> torch.Generator:
    """A generator on ``device`` for one named stream of ``seed``: each
    column draws from its own, so a column's values do not depend on which
    other columns a cell stages. Any whole ``seed`` works, negative or past
    64 bits."""
    h = hashlib.sha256(":".join([str(int(seed)), *names]).encode())
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(h.digest()[:8], "little") >> 1)
    return g


def numbered(prefix: bytes, first: int, n: int, digits: int, device):
    """(int32 offsets, uint8 pool) of ``prefix + "%0{digits}d" % i`` for i
    in [first, first + n), built on the device from digit arithmetic."""
    width = len(prefix) + digits
    mat = torch.empty((n, width), dtype=torch.uint8, device=device)
    mat[:, :len(prefix)] = torch.tensor(list(prefix), dtype=torch.uint8,
                                        device=device)
    rest = torch.arange(first, first + n, dtype=torch.int64, device=device)
    for j in range(width - 1, len(prefix) - 1, -1):
        mat[:, j] = (48 + rest % 10).to(torch.uint8)
        rest = rest // 10
    offsets = torch.arange(n + 1, dtype=torch.int32, device=device) * width
    return offsets, mat.reshape(-1)


def words(values, device):
    """(int32 offsets, uint8 pool) of a list of strings."""
    raw = [v.encode() for v in values]
    offsets = np.zeros(len(raw) + 1, np.int32)
    np.cumsum([len(r) for r in raw], out=offsets[1:])
    pool = np.frombuffer(b"".join(raw), np.uint8).copy()
    return (torch.from_numpy(offsets).to(device),
            torch.from_numpy(pool).to(device))


def strings(offsets: torch.Tensor, pool: torch.Tensor,
            codes: Optional[torch.Tensor] = None) -> np.ndarray:
    """The strings of (offsets, pool), or those at ``codes``, as a numpy
    ``bytes_`` array (one padded matrix on the tensors' device, then one
    copy to the host)."""
    offsets = offsets.to(torch.int64)
    starts, lens = offsets[:-1], offsets[1:] - offsets[:-1]
    if codes is not None:
        codes = codes.to(torch.int64)
        starts, lens = starts[codes], lens[codes]
    n = int(starts.shape[0])
    width = max(int(lens.max()) if n else 0, 1)
    col = torch.arange(width, device=pool.device)
    pos = (starts[:, None] + col[None, :]).clamp_(max=max(pool.numel() - 1,
                                                          0))
    mat = pool[pos] if pool.numel() else torch.zeros(
        (n, width), dtype=torch.uint8, device=pool.device)
    mat = torch.where(col[None, :] < lens[:, None], mat,
                      torch.zeros((), dtype=torch.uint8, device=pool.device))
    return np.ascontiguousarray(mat.cpu().numpy()).view(f"S{width}") \
        .reshape(n)


def code_of(col: Column, value: str) -> int:
    """The code of ``value`` in a dict column's strings (-1 if absent)."""
    found = np.flatnonzero(strings(col.offsets, col.pool) == value.encode())
    return int(found[0]) if found.size else -1


_WORDS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_CHUNK = 1 << 24
_MODULUS = 65521


def _checksum(t: torch.Tensor) -> tuple:
    """(sum, position-weighted sum) of a tensor's words as int64, wrapping:
    a changed, added or moved word changes it. On the tensor's device, in
    chunks."""
    w = t.contiguous().view(-1).view(_WORDS[t.element_size()])
    plain = weighted = torch.zeros((), dtype=torch.int64, device=t.device)
    for start in range(0, w.numel(), _CHUNK):
        part = w[start:start + _CHUNK].to(torch.int64)
        pos = torch.arange(start, start + part.numel(), dtype=torch.int64,
                           device=t.device) % _MODULUS + 1
        plain = plain + part.sum()
        weighted = weighted + (part * pos).sum()
    return int(plain), int(weighted)


def digest(raw: dict) -> dict:
    """The checksum of every tensor of ``{table: {column: Column}}``."""
    out = {}
    for table, cols in raw.items():
        for name, col in cols.items():
            for part in ("values", "offsets", "pool"):
                t = getattr(col, part)
                if t is not None:
                    out[f"{table}.{name}.{part}"] = _checksum(t)
    return out
