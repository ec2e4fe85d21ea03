"""`count_stats_roofline.solve`: per cent of ``count_stats``'s roofline
over the traced rounds (``portbench/roofline.py``)."""

from portbench.readers import kernel_roofline

read = kernel_roofline("count_stats")
