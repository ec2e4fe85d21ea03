"""`nodes_per_s`: see `portbench/readers.py`."""

from portbench.readers import nodes_per_s as read  # noqa: F401
