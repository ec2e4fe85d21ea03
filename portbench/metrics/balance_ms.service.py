"""`balance_ms.service`: host milliseconds a window round in the program's
``balance`` spans, self time (``portbench/spans.py``)."""

from portbench.spans import self_ms

read = self_ms("balance")
