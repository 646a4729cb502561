"""The port's benchmark: ``BENCHMARK.json`` at the root of the repository
names its cells, configurations and metrics; ``run.py`` runs one cell."""
