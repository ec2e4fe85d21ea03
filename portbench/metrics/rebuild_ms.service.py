"""`rebuild_ms.service`: host milliseconds a window round in the program's
``rebuild`` spans, self time (``portbench/spans.py``)."""

from portbench.spans import self_ms

read = self_ms("rebuild")
