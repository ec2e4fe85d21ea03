"""The benchmark's plain reference: NumPy only, nothing of the program.

``PROBLEMS`` maps a configuration's ``problem`` to its module, which has
the node evaluation (a class), ``payload_faults`` and, where the service
serves the family, ``optimum``.
"""

from __future__ import annotations

import importlib


def problem_module(name: str):
    """``portbench.reference.<name>`` (``vc``, ``ds``, ...)."""
    return importlib.import_module(f"portbench.reference.{name}")
