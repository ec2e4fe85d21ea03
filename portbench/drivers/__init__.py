"""Drivers: the loops that drive the program's entry points.  A traffic
mix names its driver (``"driver": "<name>"`` finds ``<name>.py`` here);
``run(ctx)`` sets up, measures the window and checks the answers."""
