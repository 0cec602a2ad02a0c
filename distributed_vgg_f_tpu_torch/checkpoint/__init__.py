"""Checkpoint and resume of the port's training state: the manager
(checkpoint/manager.py) and the restore that migrates the momentum
across layouts and shard counts (checkpoint/retopology.py)."""
