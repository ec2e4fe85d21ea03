"""`replay_dev_ms.solve`: device milliseconds a window round in the
program's ``replay`` device spans (``portbench/device_spans.py``)."""

from portbench.device_spans import device_ms

read = device_ms("replay")
