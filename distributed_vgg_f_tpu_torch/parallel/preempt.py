"""Preemption stop-consensus over the process group — the counterpart of
the JAX package's ``parallel/preempt.py PreemptConsensus``.

When SIGTERM lands on one rank, every rank must stop at the same step: a
rank that stopped alone would strand the others in the next collective
(the gradient exchange, the checkpoint's all-gather). So the decision is
itself a collective, issued by every rank at the same loop index, after
the step.

Every step each rank issues a one-element sum of its local flag over the
group and reads the sum it issued `LAG` = 2 steps earlier, which has long
completed: every rank reads the same value at the same index and stops
together, within LAG + 1 = 3 steps of the signal. The read never waits
for the step just enqueued:

- NCCL (a CUDA group): the flag is filled on the card, summed in place,
  and the sum copied into pinned host memory behind a CUDA event; LAG
  steps later the event is waited on (it covers work two steps old) and
  the pinned value read. The flag is never read with `.item()`, which
  would wait for the current stream and stall the pipeline every step.
- gloo (a CPU group): an asynchronous all-reduce whose work handle is
  waited on LAG steps later.

JAX's `flagged_ranks` (which ranks flagged: the gather that feeds
elastic resize) waits for ROADMAP A13b with elastic resize.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist


class PreemptConsensus:
    """Per-step asynchronous stop-consensus; one instance a fit loop, in
    a multi-process run:

        consensus = PreemptConsensus(device)
        for step in ...:
            ...train step...
            if consensus.poll(local_flag):
                checkpoint_and_stop()
    """

    LAG = 2  # steps between a sum's issue and its read

    def __init__(self, device: torch.device, group=None):
        self._group = group
        self._cuda = torch.device(device).type == "cuda"
        self._pending: collections.deque = collections.deque()
        self._decided = False
        self._issued = 0
        if self._cuda:
            # one slot a step in flight: the slot issued at step i is
            # reused at step i + LAG + 1, after its read at step i + LAG
            n = self.LAG + 1
            self._flags = torch.zeros((n, 1), dtype=torch.int32,
                                      device=device)
            self._host = torch.zeros((n, 1), dtype=torch.int32,
                                     pin_memory=True)
            self._events = [torch.cuda.Event() for _ in range(n)]

    def poll(self, local_flag: bool) -> bool:
        """Issue this step's sum of the flags and read the one issued LAG
        steps ago. True once any rank's flag has reached the read: on
        every rank at the same loop index, and from then on."""
        if self._decided:
            return True
        if self._cuda:
            slot = self._issued % (self.LAG + 1)
            flag = self._flags[slot]
            flag.fill_(int(bool(local_flag)))
            dist.all_reduce(flag, group=self._group)
            self._host[slot].copy_(flag, non_blocking=True)
            self._events[slot].record()
            self._pending.append(slot)
        else:
            flag = torch.tensor([int(bool(local_flag))], dtype=torch.int32)
            work = dist.all_reduce(flag, group=self._group, async_op=True)
            self._pending.append((flag, work))
        self._issued += 1
        if len(self._pending) > self.LAG:
            self._decided = self._read(self._pending.popleft()) > 0
        return self._decided

    def _read(self, entry) -> int:
        if self._cuda:
            self._events[entry].synchronize()
            return int(self._host[entry, 0])
        flag, work = entry
        work.wait()
        return int(flag[0])
