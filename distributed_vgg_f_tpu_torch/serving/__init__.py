"""Serving plane of the port: the bucketed engine (serving/engine.py), the
dynamic batcher (serving/batcher.py) and the HTTP server
(serving/server.py)."""
