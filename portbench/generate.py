"""The benchmark's instance generators: frozen copies of the seeded graph
generators of the paper's instance families, giving dense adjacency.

* ``gnp``: Erdős–Rényi G(n, p), the upper triangle of ``rand(n, n) < p``
  under ``numpy.random.RandomState(seed)``;
* ``reg``: a random k-regular-ish graph, the union of k random perfect
  matchings under the same generator (a repeated pair leaves two vertices
  one short).

A run's instances come from ``--seed`` by :func:`instance_seed`, so every
seed the driver may pass (any whole number, beyond 32 bits too) gives a
valid generator seed, and one seed always the same instances.
"""

from __future__ import annotations

import numpy as np


def instance_seed(seed: int, index: int) -> int:
    """The 32-bit generator seed of instance ``index`` of run ``seed``."""
    ss = np.random.SeedSequence([int(seed) % (1 << 63), int(index)])
    return int(ss.generate_state(1, np.uint32)[0])


def stream(seed: int, stream_id: int) -> np.random.Generator:
    """A generator for a run's other draws (sizes, samples), one per use."""
    return np.random.default_rng([int(seed) % (1 << 63), 1 << 20,
                                  int(stream_id)])


def gnp(n: int, p: float, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    upper = np.triu(rng.rand(n, n) < p, k=1)
    return upper | upper.T


def reg(n: int, k: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    dense = np.zeros((n, n), bool)
    for _ in range(k):
        perm = rng.permutation(n)
        for i in range(0, n - 1, 2):
            a, b = perm[i], perm[i + 1]
            dense[a, b] = dense[b, a] = True
    return dense


GENERATORS = {"gnp": gnp, "reg": reg}


def graph(spec: dict, seed: int, n: int = None) -> np.ndarray:
    """The dense adjacency of a mix's graph ``spec`` (``family`` and its
    parameters) at generator seed ``seed``; ``n`` overrides the spec's."""
    family = spec["family"]
    size = int(n if n is not None else spec["n"])
    if family == "gnp":
        return gnp(size, float(spec["p"]), seed)
    if family == "reg":
        return reg(size, int(spec["k"]), seed)
    raise ValueError(f"unknown graph family {family!r}")

