"""Drivers of the port: the program-cost summaries (``hlo_stats``), the
serving steps (``steps``) and the batched serving driver (``serve``)."""
