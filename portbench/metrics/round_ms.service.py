"""`round_ms.service`: see `portbench/readers.py`, `round_ms`."""

from portbench.readers import round_ms as read  # noqa: F401
