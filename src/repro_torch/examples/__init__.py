"""The port's twins of the repository's example scripts (``examples/*.py``):
the same arguments, output and checks through the port's public entry
points, plus ``--device`` (default ``cuda``; ``cpu`` runs the kernels'
plain versions).  Run as ``python -m repro_torch.examples.<name>``."""
