"""Data and sequence parallelism over torch.distributed: the process-group
start (`distributed`); the gradient exchange — the mean collectives and
the wire cast (`collectives`), the bucket layout and its async exchange
(`buckets`), the ZeRO flat layout (`zero`); the preemption
stop-consensus (`preempt`); and sequence-parallel
attention — the ring shift and tiled all-to-all (`collectives`) and the
three entry points of the JAX package's parallel/ring_attention.py,
ring_flash.py and ulysses.py, each on the local (B, T_loc, H, D) shard of
one process."""
