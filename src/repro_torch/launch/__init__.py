"""Launchers of the port: the stencil serving front (``stencil_serve``),
LM serving (``serve``) and training (``train``), the production meshes
(``mesh``) and the sharding dry run (``dryrun``)."""
