"""Utilities of the port: seeded generators (utils/rng.py) and the
throughput meter (utils/meter.py)."""
