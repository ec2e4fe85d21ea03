"""The port's LM substrate in plain PyTorch (counterpart of
``repro.models``): configuration (``config``), parameters (``params``),
layers, attention, the Mamba-2 mixer (``ssm``), blocks and the model of
the dense, ssm and hybrid families.  ``attention.blocked_attention`` and
``ssm.ssd_chunked`` are the plain versions of the ``flash_attention`` and
``ssd_scan`` kernels."""
