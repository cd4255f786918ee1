"""Embedding cache for repeat queries (id -> embedding LRU).

Port of ``repro/serving/cache.py``, with its contract: capacity is a row
count, eviction least-recently-used, ``hits`` / ``misses`` counted per key
looked up, ``get_many`` / ``put_many`` the batch interface, so a flush with
mixed hits and misses embeds only the miss rows.

Tower inference dominates the serving cost for repeat visitors: the user
embedding only changes when the model (or the user's features) changes,
while real traffic is heavily skewed toward returning users.  The kNN scan
itself always runs (the corpus is what changes between visits).

The rows live in one ``[capacity, dim]`` slab, allocated at the first put
on the rows' device and dtype; the LRU maps each key to its slot.  A batch
costs one scatter into the slab for its misses (``put_many``) and one
gather for its hits (``lookup`` then ``gather``), and a cached row holds
no memory beyond its slot.  The service keeps the slab on its own device,
so a hit costs no copy to or from the host.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch


class EmbeddingCache:
    def __init__(self, capacity: int = 4096):
        assert capacity >= 0
        self.capacity = int(capacity)
        self._slots: OrderedDict[int, int] = OrderedDict()  # key -> slot, LRU first
        self._free = list(range(self.capacity - 1, -1, -1))
        self._slab: torch.Tensor | None = None
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._slots)

    def __contains__(self, key) -> bool:
        return int(key) in self._slots

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else float("nan")

    def lookup(self, keys) -> list[int]:
        """Each key's slot in the slab, -1 where it misses; counted and
        moved to most-recent as ``get`` does."""
        slots = []
        for key in keys:
            k = int(key)
            s = self._slots.get(k)
            if s is None:
                self.misses += 1
                slots.append(-1)
            else:
                self.hits += 1
                self._slots.move_to_end(k)
                slots.append(s)
        return slots

    def gather(self, slots) -> torch.Tensor:
        """The rows at ``slots`` (from ``lookup``, before any later put), a
        new [len(slots), dim] tensor."""
        return self._slab[torch.as_tensor(slots, device=self._slab.device)]

    def get(self, key) -> torch.Tensor | None:
        (s,) = self.lookup([key])
        return None if s < 0 else self.gather([s])[0]

    def get_many(self, keys) -> tuple[dict[int, torch.Tensor], list[int]]:
        """Split keys into ({key: cached row}, [missing keys]) in one pass."""
        keys = [int(key) for key in keys]
        slots = self.lookup(keys)
        hit = [(k, s) for k, s in zip(keys, slots) if s >= 0]
        found = {}
        if hit:
            found = dict(zip([k for k, _ in hit], self.gather([s for _, s in hit]).unbind(0)))
        return found, [k for k, s in zip(keys, slots) if s < 0]

    def put(self, key, row) -> None:
        self.put_many([key], row[None])

    def put_many(self, keys, rows) -> None:
        """Store ``rows`` ([n, dim]: a tensor, or rows numpy stacks) under
        ``keys`` in order, as n puts would: a key put twice keeps its last row."""
        if self.capacity == 0 or len(keys) == 0:
            return
        rows = rows if isinstance(rows, torch.Tensor) else torch.as_tensor(np.asarray(rows))
        if self._slab is None:
            self._slab = rows.new_empty((self.capacity, rows.shape[1]))
        src = {}  # slot -> row index, the last write to a slot wins
        for i, key in enumerate(keys):
            k = int(key)
            s = self._slots.get(k)
            if s is not None:
                self._slots.move_to_end(k)
            elif self._free:
                s = self._free.pop()
                self._slots[k] = s
            else:
                _, s = self._slots.popitem(last=False)
                self._slots[k] = s
            src[s] = i
        dev = self._slab.device
        self._slab[torch.as_tensor(list(src), device=dev)] = rows.to(
            device=dev, dtype=self._slab.dtype)[torch.as_tensor(list(src.values()), device=dev)]

    def invalidate(self, key=None) -> None:
        """Drop one key, or everything (model push / feature refresh)."""
        if key is None:
            self._slots.clear()
            self._free = list(range(self.capacity - 1, -1, -1))
        else:
            s = self._slots.pop(int(key), None)
            if s is not None:
                self._free.append(s)

    def stats(self) -> dict:
        return {"size": len(self), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses,
                "hit_rate": self.hit_rate}
