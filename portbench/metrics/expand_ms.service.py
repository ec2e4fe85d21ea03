"""`expand_ms.service`: host milliseconds a window round in the program's
``expand`` spans, self time (``portbench/spans.py``)."""

from portbench.spans import self_ms

read = self_ms("expand")
