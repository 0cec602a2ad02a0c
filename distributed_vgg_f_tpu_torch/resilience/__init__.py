"""Resilience of the port's training loop: the host-side non-finite step
guard (resilience/guard.py)."""
