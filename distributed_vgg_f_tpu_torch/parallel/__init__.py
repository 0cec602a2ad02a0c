"""Sequence-parallel attention over torch.distributed: the process-group
start (`distributed`), the ring shift and tiled all-to-all
(`collectives`), and the three entry points of the JAX package's
parallel/ring_attention.py, ring_flash.py and ulysses.py, each on the
local (B, T_loc, H, D) shard of one process."""
