"""Pipeline parallelism of the port (counterpart of
``repro.distributed``): the GPipe schedule over a single-process mesh
(``pipeline_parallel``)."""
