"""Serving plane of the port: the bucketed engine (serving/engine.py), the
dynamic batcher (serving/batcher.py), the admission controller over its
window (serving/controller.py), the tier ladder (serving/tiers.py) and
the HTTP server with its (model, tier) router (serving/server.py)."""
