"""Ops of the port: LRN forward and backward, unfused and with the ReLU
before it fused (plain versions and the autograd Functions in ops/lrn.py,
Hopper kernel wrappers in ops/lrn_cuda.py), the ceil-mode max-pool (ops/pooling.py), the losses
(ops/losses.py) and the top-k metric (ops/metrics.py)."""
