"""Data plane of the port: the device finish of the u8 ingest wire
(data/device_ingest.py)."""
