"""Training data of the port (counterpart of ``repro.data``): the
deterministic synthetic token pipeline (``pipeline``)."""
