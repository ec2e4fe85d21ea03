"""torch-lint: static analysis of the PyTorch/CUDA port (counterpart of
``repro.analysis``).

An AST pass that holds, before any card sees the code, the invariants the
card can only show by failing (or not at all):

  * ``trace-safety``     — no host<->device sync inside the round loop
                           (``ROUND_LOOP_ROOTS`` and all they reach);
  * ``kernel-contract``  — every ctypes binding matches its ``extern
                           "C"`` launcher in ``kernels/csrc``; every
                           kernel has a wrapper, a plain version, a
                           test and a smoke entry; launches are counted;
                           the build targets ``sm_90a``;
  * ``telemetry-schema`` — emit()/trace ``write()`` call sites are valid
                           against the port's ``EVENT_KINDS`` /
                           ``TRACE_KINDS``;
  * ``api-hygiene``      — the front-door exports are snapshotted in
                           ``analysis/api_surface.txt`` and deprecation
                           shims carry the exactly-once pattern.

Front doors: :func:`lint_paths` and ``python -m repro_torch.analysis``.
The package is stdlib-only (all of it but ``api_surface``, which renders
the live modules): it imports neither torch nor the rest of the port.
"""

from repro_torch.analysis.core import (
    Finding,
    LintResult,
    RepoContext,
    Rule,
    all_rules,
    lint_paths,
)

# Importing the rule modules registers their rules.
from repro_torch.analysis import api_hygiene  # noqa: F401  (registration)
from repro_torch.analysis import kernel_contract  # noqa: F401
from repro_torch.analysis import telemetry  # noqa: F401  (registration)
from repro_torch.analysis import trace_safety  # noqa: F401

__all__ = [
    "Finding",
    "LintResult",
    "RepoContext",
    "Rule",
    "all_rules",
    "lint_paths",
]
