"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``BENCHMARK.json`` at the root of the repository names the cells; one
run of one cell is ``python3 portbench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>``.  The harness measures ``repro_torch``
only: no module it loads is ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``repro`` (top-level names compared whole), and the plain
reference in ``reference/`` imports nothing of the program.
"""
