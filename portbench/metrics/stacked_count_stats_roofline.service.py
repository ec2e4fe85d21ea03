"""`stacked_count_stats_roofline.service`: per cent of
``stacked_count_stats``'s roofline over the traced rounds
(``portbench/roofline.py``)."""

from portbench.readers import kernel_roofline

read = kernel_roofline("stacked_count_stats")
