"""ProblemSpec registry of the port (counterpart of ``repro.registry``).

A problem family is one registration::

    @register_problem("vc", parse=parse_graph_instance,
                      oracle=lambda g: make_vertex_cover_py(g))
    def make_vertex_cover(graph, device="cuda"):
        ...

which binds the engine factory, the serial ``PyProblem`` oracle and the
instance-spec parser under one name.  The reference's ``backends``
capability list is gone: the device of the problem's tables chooses
between the CUDA kernel and the plain version.  Registering ``pack`` and
``family_id`` makes a family admissible to the multi-tenant
``repro_torch.service.SolverService``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

__all__ = [
    "ProblemHandle",
    "ProblemSpec",
    "UnknownProblemError",
    "get",
    "instance_size",
    "names",
    "problem",
    "register_problem",
]


class UnknownProblemError(KeyError):
    """Lookup of a problem family that was never registered."""


_REGISTRY: Dict[str, "ProblemSpec"] = {}


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """Everything the port needs to know about one problem family.

    Attributes:
      name: registry key (the CLI's ``--problem`` value).
      factory: the engine-problem factory as registered.
      builder: ``(instance, device) -> BinaryProblem``.
      oracle: ``instance -> PyProblem`` — the serial reference factory.
      parse: ``instance-spec str -> instance``.
      family_id: stacked-table family id (``repro_torch.service.
        batch_problem``) when the family is servable, else None.
      pack: ``(instance, n) -> (adj, fullm, family)`` service packing, or
        None when the family cannot ride the stacked tables.
      size: ``instance -> int`` — instance size, checked against the
        service's ``max_n`` (defaults to ``.n``).
      doc: one-line description shown in CLI help.
    """

    name: str
    factory: Callable[..., Any]
    builder: Callable[[Any, str], Any]
    oracle: Callable[[Any], Any]
    parse: Callable[[str], Any]
    family_id: Optional[int] = None
    pack: Optional[Callable[[Any, int], Any]] = None
    size: Callable[[Any], int] = lambda instance: int(instance.n)
    doc: str = ""

    @property
    def servable(self) -> bool:
        """True when the family can be admitted to the solver service."""
        return self.pack is not None and self.family_id is not None

    def build(self, instance: Any, device: str = "cuda") -> Any:
        """Build the engine ``BinaryProblem`` with its tables on
        ``device``."""
        return self.builder(instance, device)

    def label(self, instance: Any) -> str:
        """Human-readable instance label for logs."""
        return str(getattr(instance, "name", instance))


@dataclasses.dataclass(frozen=True)
class ProblemHandle:
    """A (family, instance) pair — the facade's unit of work."""

    spec: ProblemSpec
    instance: Any

    def build(self, device: str = "cuda") -> Any:
        return self.spec.build(self.instance, device)

    def oracle(self) -> Any:
        return self.spec.oracle(self.instance)

    @property
    def label(self) -> str:
        return f"{self.spec.name}:{self.spec.label(self.instance)}"


def register_problem(name: str, *, parse: Callable[[str], Any],
                     oracle: Callable[[Any], Any],
                     pack: Optional[Callable[[Any, int], Any]] = None,
                     family_id: Optional[int] = None,
                     size: Optional[Callable[[Any], int]] = None,
                     doc: str = ""):
    """Decorator: register the decorated engine factory as family ``name``;
    an instance reaches it as ``factory(instance, device=device)``."""

    def deco(factory):
        if name in _REGISTRY:
            raise ValueError(f"problem {name!r} registered twice")

        def builder(instance, device):
            return factory(instance, device=device)

        kwargs: Dict[str, Any] = {}
        if size is not None:
            kwargs["size"] = size
        _REGISTRY[name] = ProblemSpec(
            name=name, factory=factory, builder=builder, oracle=oracle,
            parse=parse, family_id=family_id, pack=pack, doc=doc, **kwargs)
        return factory

    return deco


def _ensure_builtins() -> None:
    # Built-in families self-register when repro_torch.problems is
    # imported; importing lazily keeps registry <-> problems acyclic.
    import repro_torch.problems  # noqa: F401


def get(name: str) -> ProblemSpec:
    """Registered spec for family ``name`` (raises UnknownProblemError)."""
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownProblemError(
            f"unknown problem family {name!r} (registered: "
            f"{', '.join(sorted(_REGISTRY))})") from None


def names() -> Tuple[str, ...]:
    """All registered family names, sorted."""
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))


def instance_size(name: str, instance: Any) -> int:
    """Registered ``size()`` of ``instance`` under family ``name``: what
    the service checks against ``max_n`` and the ``ShortestJobFirst``
    policy orders by."""
    return int(get(name).size(instance))


def problem(name: str, instance: Any) -> ProblemHandle:
    """Resolve (family, instance) into a :class:`ProblemHandle`;
    ``instance`` may be an instance-spec string, parsed by the family's
    registered parser."""
    spec = get(name)
    if isinstance(instance, str):
        instance = spec.parse(instance)
    return ProblemHandle(spec=spec, instance=instance)
