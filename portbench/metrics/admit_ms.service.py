"""`admit_ms.service`: host milliseconds a window round in the program's
``admit`` spans, self time (less its ``rebuild``) (``portbench/spans.py``)."""

from portbench.spans import self_ms

read = self_ms("admit")
