"""What the drivers share: the program's problem handle built from the
benchmark's dense adjacency, and the host copy of a payload."""

from __future__ import annotations

import numpy as np

from portbench.reference.bits import pack


def graph(dense: np.ndarray, name: str):
    """The program's ``Graph`` of ``dense``: it receives only the packed
    adjacency the benchmark generated."""
    from repro_torch.problems.graphs import Graph
    return Graph(n=int(dense.shape[0]), adj=pack(dense), name=name)


def handle(problem: str, dense: np.ndarray, name: str):
    from repro_torch import registry
    return registry.problem(problem, graph(dense, name))


def words(t) -> np.ndarray:
    """A payload tensor's words as ``uint32``."""
    a = t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)
    return a.view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)
