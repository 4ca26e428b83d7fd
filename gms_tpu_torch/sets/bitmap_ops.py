"""Batched set algebra over bitmap rows — the port of gms_tpu/sets/bitmap_ops.py.

Role of the reference's RoaringSet ops (gms/representations/sets/roaring_set.h
:77-225: &, |, -, and_cardinality). Rows are fixed-width bit-word vectors;
intersection is word-AND, cardinality is popcount + sum.

All rows: int32[B, W] (any leading shape for the counts), words carrying the
bits of gms_tpu's uint32 words. Element j of the set <-> bit (j & 31) of word
(j >> 5). `>>` on int32 is arithmetic, so every shift is masked after it.

The four counts (`cardinality`, `intersect_count`, `union_count`,
`difference_count`) are one hand-written CUDA kernel, `rows_count`
(csrc/bitmap_count.cu, entry bitmap_rows_count). For CPU tensors it runs its
plain version; for CUDA tensors it launches the kernel or raises, and adds one
to `LAUNCHES["bitmap_rows_count"]`. The rest is torch glue, as in gms_tpu.
"""

from __future__ import annotations

import torch

from gms_tpu_torch import _kernels
from gms_tpu_torch.graphs.tiles import SENTINEL

_SENT = int(SENTINEL)

# Kernel launches, counted only where the CUDA kernel launches.
LAUNCHES = {"bitmap_rows_count": 0}

# the word combination each count takes: a, a & b, a | b, a & ~b
_OPS = {"card": 0, "and": 1, "or": 2, "andnot": 3}


def reset_launches() -> None:
    LAUNCHES["bitmap_rows_count"] = 0


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """int64 popcount of each int32 bit word (torch has no popcount op).

    SWAR on the word widened to int64 and masked to its 32 bits.
    """
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 words with the same 32 bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _bit64(x: torch.Tensor) -> torch.Tensor:
    """int64 value of bit (x & 31)."""
    return torch.ones_like(x, dtype=torch.int64) << (x.long() & 31)


def popcount(words):
    """int32 popcount of each word."""
    return popcount32(words).to(torch.int32)


def rows_count_plain(a, b, *, op: str):
    """Plain version of rows_count."""
    x = {"card": lambda: a, "and": lambda: a & b, "or": lambda: a | b,
         "andnot": lambda: a & ~b}[op]()
    return popcount32(x).sum(dim=-1).to(torch.int32)


def rows_count(a, b=None, *, op: str):
    """int32[...] = popcount(a op b) per row, op in card (a alone), and, or,
    andnot (a & ~b). Replaces the counts of gms_tpu's sets/bitmap_ops.py
    (:22-49)."""
    name = "bitmap_rows_count"
    if op not in _OPS:
        raise ValueError(f"{name}: unknown op {op!r}")
    b = a if b is None else b
    if a.dtype != torch.int32 or b.dtype != torch.int32 or a.dim() < 1:
        raise TypeError(f"{name}: rows must be int32 words, got {a.dtype} "
                        f"{tuple(a.shape)} and {b.dtype} {tuple(b.shape)}")
    if a.shape != b.shape:
        raise ValueError(f"{name}: shapes differ: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name}: rows must be contiguous")
    if not _kernels.on_cuda(name, a, b):
        return rows_count_plain(a, b, op=op)
    W = a.shape[-1]
    B = a.numel() // W if W else 0
    out = torch.zeros(a.shape[:-1], dtype=torch.int32, device=a.device)
    _kernels.launch("bitmap_count", "bitmap_rows_count", a, b, B, W, _OPS[op],
                    out)
    LAUNCHES[name] += 1
    return out


def cardinality(rows):
    """int32[B]."""
    return rows_count(rows, op="card")


def intersect(a, b):
    return a & b


def intersect_count(a, b):
    """int32[B] = popcount(a & b) — Roaring and_cardinality equivalent."""
    return rows_count(a, b, op="and")


def union(a, b):
    return a | b


def union_count(a, b):
    return rows_count(a, b, op="or")


def difference(a, b):
    return a & ~b


def difference_count(a, b):
    return rows_count(a, b, op="andnot")


def contains(rows, x):
    """bool[B]: bit x_i set in row_i."""
    word = torch.gather(rows, 1, (x[:, None] >> 5).long())[:, 0]
    return ((word >> (x & 31)) & 1) == 1


def _onehot_bit(rows, x):
    """int32[B, W]: bit x_i in word x_i >> 5 of row i; nothing where that
    word lies outside [0, W), as gms_tpu's one_hot drops it."""
    lanes = torch.arange(rows.shape[1], device=rows.device)
    hit = lanes[None, :] == (x[:, None] >> 5).long()
    return torch.where(hit, int32_bits(_bit64(x))[:, None], 0)


def add(rows, x):
    return rows | _onehot_bit(rows, x)


def remove(rows, x):
    return rows & ~_onehot_bit(rows, x)


def from_ids(ids_rows, width_words: int):
    """Convert padded sorted int rows -> bitmap rows.

    ids_rows: int32[B, D] SENTINEL-padded, each row sorted. Returns
    int32[B, W]. torch has no scatter-OR: once a sorted row's repeats (its
    equal neighbours) are dropped its ids are distinct, so the bits landing
    in one word are distinct and the int64 scatter_add of their values
    equals their OR. Ids whose word lies outside [0, W) are dropped, as
    gms_tpu's one_hot drops them.
    """
    B = ids_rows.shape[0]
    word = (ids_rows >> 5).long()
    repeat = torch.zeros_like(ids_rows, dtype=torch.bool)
    repeat[:, 1:] = ids_rows[:, 1:] == ids_rows[:, :-1]
    keep = ((ids_rows != _SENT) & ~repeat & (word >= 0)
            & (word < width_words))
    idx = torch.where(keep, word, width_words)
    bits = torch.where(keep, _bit64(ids_rows), 0)
    out = torch.zeros((B, width_words + 1), dtype=torch.int64,
                      device=ids_rows.device)
    out.scatter_add_(1, idx, bits)
    return int32_bits(out[:, :width_words])


def to_ids(bitmap_rows, width_ids: int):
    """Convert bitmap rows -> padded sorted int rows of width `width_ids`."""
    B, W = bitmap_rows.shape
    ids = torch.arange(W * 32, dtype=torch.int32, device=bitmap_rows.device)
    word = torch.repeat_interleave(bitmap_rows, 32, dim=1)  # lane j: word j>>5
    bitset = ((word >> (ids & 31)) & 1) == 1
    padded = torch.where(bitset, ids, _SENT)
    return torch.sort(padded, dim=1).values[:, :width_ids]
