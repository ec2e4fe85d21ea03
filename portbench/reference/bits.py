"""Bitset words of the benchmark's data: bit ``v % 32`` of word ``v // 32``
holds vertex ``v`` (little-endian ``uint32`` words)."""

from __future__ import annotations

import numpy as np

WORD = 32


def num_words(n: int) -> int:
    return (n + WORD - 1) // WORD


def pack(dense: np.ndarray) -> np.ndarray:
    """bool[..., n] -> uint32[..., ceil(n / 32)]."""
    dense = np.asarray(dense, bool)
    n = dense.shape[-1]
    w = num_words(n)
    pad = np.zeros(dense.shape[:-1] + (w * WORD,), bool)
    pad[..., :n] = dense
    as_bytes = np.packbits(pad, axis=-1, bitorder="little")
    return np.ascontiguousarray(as_bytes).view("<u4").astype(np.uint32)


def unpack(words: np.ndarray, n: int) -> np.ndarray:
    """uint32[..., w] -> bool[..., n]."""
    words = np.ascontiguousarray(np.asarray(words).astype(np.uint32))
    bits = np.unpackbits(words.view(np.uint8), axis=-1, bitorder="little")
    return bits[..., :n].astype(bool)


def onehot(v: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((v.shape[0], n), bool)
    out[np.arange(v.shape[0]), v] = True
    return out


def first_argmax(counts: np.ndarray) -> tuple:
    """(max, index of its first occurrence) per row; (-1, 0) for a row
    with nothing valid (every count -1)."""
    best = counts.max(axis=1)
    return best, counts.argmax(axis=1)
