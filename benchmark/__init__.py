"""The port's benchmark: see ``BENCHMARK.json`` at the checkout's root and ``run.py``."""
