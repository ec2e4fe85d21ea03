"""`request_wait_p50_s.service`: the median of the program's ``queued``
spans, submission to admission, over the requests admitted in the window
(``portbench/spans.py``)."""

from portbench.spans import request_wait_p50_s as read  # noqa: F401
