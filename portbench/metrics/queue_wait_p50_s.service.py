"""`queue_wait_p50_s.service`: see `portbench/readers.py`, `queue_wait_p50_s`."""

from portbench.readers import queue_wait_p50_s as read  # noqa: F401
