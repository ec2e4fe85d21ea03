"""`device_ops_per_round.service`: see `portbench/readers.py`, `device_ops_per_round`."""

from portbench.readers import device_ops_per_round as read  # noqa: F401
