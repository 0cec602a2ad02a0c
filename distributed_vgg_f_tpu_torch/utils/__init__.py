"""Utilities of the port: seeded generators (utils/rng.py), the
throughput meter (utils/meter.py) and the JSONL metrics logger
(utils/logging.py)."""
