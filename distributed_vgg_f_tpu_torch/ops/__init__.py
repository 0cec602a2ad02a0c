"""Ops of the port: LRN (plain version in ops/lrn.py, Hopper kernel
wrapper in ops/lrn_cuda.py) and the ceil-mode max-pool
(ops/pooling.py)."""
