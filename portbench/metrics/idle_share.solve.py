"""`idle_share.solve`: see `portbench/readers.py`, `idle_share`."""

from portbench.readers import idle_share as read  # noqa: F401
