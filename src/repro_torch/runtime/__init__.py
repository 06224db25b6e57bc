"""The port's runtime: the train and serve step builders (``trainer``),
fault tolerance (``fault``), the logical-axis rules (``mesh_rules``) and
pipeline parallelism (``pipeline_parallel``)."""
