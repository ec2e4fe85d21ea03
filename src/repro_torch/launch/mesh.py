"""The production mesh of the dry runs and the card's constants
(counterpart of ``repro.launch.mesh``).

``make_production_mesh`` is a function, never a module-level constant,
so importing this module touches no device.  The reference's mesh is 16
x 16 = 256 TPU chips on axes (data, model), or 2 x 16 x 16 = 512 with a
``pod`` axis; the port's mesh is the flat ``workers`` ring of
``core.distributed.Mesh``, and its LM runs on one device, so the 2-D axes
have no counterpart.  The production mesh is 256 (or 512) placeholder
shards on ``meta``: each stands for a card of its own, and nothing is
allocated.  The reference's ``make_host_mesh`` is
``core.distributed.make_mesh(n, "cpu")``.

The constants are an NVIDIA H100 SXM's (data sheet): the rates the
kernels' bounds use (``kernels.autotune``), 80 GB of HBM, and NVLink 4
at 450 GB/s a direction (900 GB/s both ways), the link term for shards
on distinct cards.
"""

from __future__ import annotations

import torch

from repro_torch.core.distributed import Mesh
from repro_torch.kernels.autotune import HBM_BYTES_PER_S, PEAK_FLOPS

PEAK_FLOPS_BF16 = PEAK_FLOPS[torch.bfloat16]      # per card
HBM_BW = HBM_BYTES_PER_S                          # bytes/s per card
LINK_BW = 450e9                                   # NVLink 4, one direction
HBM_BYTES = 80 * 10 ** 9                          # 80 GB per card


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """256 placeholder shards on ``meta`` (512 with ``multi_pod``): the
    reference's 16 x 16 (2 x 16 x 16) mesh in row-major order."""
    return Mesh(["meta"] * (512 if multi_pod else 256))
