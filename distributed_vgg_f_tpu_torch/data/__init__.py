"""Data plane of the port: the device finish of the u8 ingest wire
(data/device_ingest.py), the train step's on-device augmentation
(data/augment.py) and the seeded u8 batches the trainer feeds
(data/synthetic.py)."""
