"""`latency_p95_s`: see `portbench/readers.py`."""

from portbench.readers import latency_p95_s as read  # noqa: F401
