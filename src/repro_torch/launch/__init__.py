"""Drivers of the port: the step builders (``steps``), the serving and
training drivers (``serve``, ``train``), the program-cost summaries
(``hlo_stats``), and the mesh tooling: meshes and rank spawning (``mesh``),
abstract inputs and their shardings (``inputs``), the dry run
(``dryrun``) and its roofline reader (``roofline``)."""
