"""Packed-bitset graphs: the numpy substrate of the PyTorch port.

A numpy copy of ``repro.problems.graphs`` (the port imports nothing of
``repro``): the same ``uint32[n, w]`` adjacency rows, ``w = ceil(n/32)``,
built by the same seeded generators, so every table here equals the
reference's byte for byte.  The engine holds these words on the device
as ``int32`` with the same bits (``repro_torch.convert``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

WORD = 32

#: Popcount of every byte value (numpy < 2.0 has no ``bitwise_count``).
_POP8 = np.array([bin(i).count("1") for i in range(256)], np.int64)


def popcount(words: np.ndarray) -> np.ndarray:
    """Per-word popcount of a ``uint32`` array (same shape, int64)."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    per_byte = _POP8[words.view(np.uint8)]
    return per_byte.reshape(words.shape + (4,)).sum(axis=-1)


@dataclasses.dataclass(frozen=True)
class Graph:
    """An undirected graph with packed adjacency rows.

    Attributes:
      n: number of vertices (ids 0..n-1).
      adj: uint32[n, w] packed adjacency matrix (symmetric, no self loops).
      name: label used in logs.
    """

    n: int
    adj: np.ndarray
    name: str = "graph"

    @property
    def words(self) -> int:
        return self.adj.shape[1]

    @property
    def m(self) -> int:
        return int(popcount(self.adj).sum()) // 2

    def degrees(self) -> np.ndarray:
        return popcount(self.adj).sum(axis=1).astype(np.int32)


def num_words(n: int) -> int:
    return (n + WORD - 1) // WORD


def full_mask(n: int) -> np.ndarray:
    """uint32[w] with bits 0..n-1 set (the all-alive mask)."""
    w = num_words(n)
    mask = np.zeros(w, np.uint32)
    for i in range(n):
        mask[i // WORD] |= np.uint32(1) << np.uint32(i % WORD)
    return mask


def bit(v: int, w: int) -> np.ndarray:
    """uint32[w] with only bit v set."""
    out = np.zeros(w, np.uint32)
    out[v // WORD] = np.uint32(1) << np.uint32(v % WORD)
    return out


def pack_adjacency(dense: np.ndarray, name: str = "graph") -> Graph:
    """Pack a dense bool/int adjacency matrix into a Graph."""
    dense = np.asarray(dense)
    n = dense.shape[0]
    dense = (dense != 0)
    dense = dense | dense.T
    np.fill_diagonal(dense, False)
    w = num_words(n)
    adj = np.zeros((n, w), np.uint32)
    for i in range(n):
        for j in np.nonzero(dense[i])[0]:
            adj[i, j // WORD] |= np.uint32(1) << np.uint32(j % WORD)
    return Graph(n=n, adj=adj, name=name)


def gnp_graph(n: int, p: float, seed: int, name: str = "") -> Graph:
    """Erdős–Rényi G(n, p)."""
    rng = np.random.RandomState(seed)
    upper = rng.rand(n, n) < p
    dense = np.triu(upper, k=1)
    return pack_adjacency(dense, name or f"gnp_{n}_{p}_{seed}")


def circulant_graph(n: int, offsets, name: str = "") -> Graph:
    """Circulant graph: v ~ v±o (mod n) for each offset o (every vertex
    has the same degree, so every degree pass is one long tie)."""
    dense = np.zeros((n, n), bool)
    for v in range(n):
        for o in offsets:
            dense[v][(v + o) % n] = True
            dense[v][(v - o) % n] = True
    return pack_adjacency(dense, name or f"circulant_{n}_{tuple(offsets)}")


def cell60_graph(n: int = 300) -> Graph:
    """4-regular 300-vertex circulant — the paper's 60-cell analogue."""
    return circulant_graph(n, (1, 7), name="60cell-analogue")


def random_regularish_graph(n: int, k: int, seed: int, name: str = "") -> Graph:
    """k-regular-ish graph via random perfect matchings (union of k)."""
    rng = np.random.RandomState(seed)
    dense = np.zeros((n, n), bool)
    for _ in range(k):
        perm = rng.permutation(n)
        for i in range(0, n - 1, 2):
            a, b = perm[i], perm[i + 1]
            dense[a, b] = dense[b, a] = True
    return pack_adjacency(dense, name or f"reg_{n}_{k}_{seed}")


def parse_graph_instance(spec: str) -> Graph:
    """Parse the graph instance-spec grammar:

      ``gnp:<n>:<p*100>:<seed>`` — Erdős–Rényi G(n, p);
      ``reg:<n>:<k>:<seed>``     — random k-regular-ish graph;
      ``cell60``                 — the 4-regular 60-cell analogue.
    """
    if spec == "cell60":
        return cell60_graph()
    kind, *rest = spec.split(":")
    try:
        if kind == "gnp":
            n, p100, seed = (int(x) for x in rest)
            return gnp_graph(n, p100 / 100.0, seed=seed)
        if kind == "reg":
            n, k, seed = (int(x) for x in rest)
            return random_regularish_graph(n, k, seed=seed)
    except (TypeError, ValueError) as e:
        raise ValueError(f"bad {kind} instance spec {spec!r}: {e}") from None
    raise ValueError(
        f"unknown instance spec {spec!r} (want gnp:<n>:<p*100>:<seed>, "
        f"reg:<n>:<k>:<seed> or cell60)")
