"""`lane_util.service`: see `portbench/readers.py`, `lane_util`."""

from portbench.readers import lane_util as read  # noqa: F401
