"""Models of the port: VGG-F (models/vggf.py), the registry
(models/registry.py) and the per-model ingest contract
(models/ingest.py)."""
