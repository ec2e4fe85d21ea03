"""Plain PyTorch model pieces of the port: so far only the oracles of the
``flash_attention`` and ``ssd_scan`` kernels (``attention.py``,
``ssm.py``)."""
