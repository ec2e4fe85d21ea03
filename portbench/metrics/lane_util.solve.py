"""`lane_util.solve`: see `portbench/readers.py`, `lane_util`."""

from portbench.readers import lane_util as read  # noqa: F401
