"""S ranks as threads of one process, for the row split's tests.

``run_threads(S, fn)`` calls ``fn(comm)`` on S threads, each with a
``ThreadComm`` of rank s: the collectives of ``parallel/comm.py`` that the
row split and its Simulation use (``sum``, ``all_gather``, ``broadcast``,
``barrier``), done through shared slots and a barrier, every rank adding
or concatenating the slots in rank order (so every rank gets the same
bits, as from a process group). Returns each rank's result; the first
rank's exception is raised. Every wait is bounded by ``TIMEOUT`` seconds:
a rank that never reaches a collective breaks the barrier for all.
"""

import threading

import torch

TIMEOUT = 300.0


class _Group:
    def __init__(self, size):
        self.size = size
        self.barrier = threading.Barrier(size, timeout=TIMEOUT)
        self.slots = [None] * size


class ThreadComm:
    def __init__(self, group, rank):
        self._g = group
        self.rank = rank
        self.world_size = group.size
        self.group = None

    def _exchange(self, t):
        self._g.slots[self.rank] = t
        self._g.barrier.wait()
        parts = list(self._g.slots)
        self._g.barrier.wait()
        return parts

    def sum(self, t):
        parts = self._exchange(t)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def sum_many(self, tensors):
        return [self.sum(t) for t in tensors]

    def all_gather(self, t):
        return torch.cat(self._exchange(t))

    def broadcast(self, t):
        return self._exchange(t)[0].clone()

    def barrier(self):
        self._exchange(None)


def run_threads(size, fn):
    group = _Group(size)
    results = [None] * size
    errors = []

    def work(rank):
        try:
            results[rank] = fn(ThreadComm(group, rank))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
            group.barrier.abort()

    threads = [threading.Thread(target=work, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    if any(t.is_alive() for t in threads):
        group.barrier.abort()
        raise TimeoutError(f"run_threads: a rank still runs after {TIMEOUT} s")
    if errors:
        raise errors[0]
    return results
