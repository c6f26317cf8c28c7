"""Feature-cache eviction policies (counterpart of
``dgl_tpu/graphbolt/impl/cache_policy.py``; reference
``graphbolt/src/cache_policy.h``:
S3FifoCachePolicy :256, SieveCachePolicy :389, LruCachePolicy :485,
ClockCachePolicy :579).

Host-side Python implementations with the same algorithms; the cache maps
feature-row keys -> slots in a host row buffer (see
``feature_store.CachedFeature``).
"""
from __future__ import annotations

from collections import OrderedDict, deque
from typing import Dict, List, Optional

__all__ = ["CachePolicy", "LRUPolicy", "ClockPolicy", "SievePolicy",
           "S3FifoPolicy"]


class CachePolicy:
    """Interface: ``query(keys) -> (hit_keys, slots)``; ``insert(key) ->
    (slot, evicted_key)``."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self.key_to_slot: Dict[int, int] = {}
        self.free: List[int] = list(range(self.capacity))[::-1]

    def lookup(self, key: int) -> Optional[int]:
        raise NotImplementedError

    def insert(self, key: int):
        raise NotImplementedError

    def __contains__(self, key):
        return key in self.key_to_slot

    def __len__(self):
        return len(self.key_to_slot)


class LRUPolicy(CachePolicy):
    """(reference ``LruCachePolicy``, cache_policy.h:485)."""

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self.order: "OrderedDict[int, int]" = OrderedDict()

    def lookup(self, key):
        slot = self.key_to_slot.get(key)
        if slot is not None:
            self.order.move_to_end(key)
        return slot

    def insert(self, key):
        if key in self.key_to_slot:
            self.order.move_to_end(key)
            return self.key_to_slot[key], None
        evicted = None
        if self.free:
            slot = self.free.pop()
        else:
            evicted, slot = self.order.popitem(last=False)
            del self.key_to_slot[evicted]
        self.key_to_slot[key] = slot
        self.order[key] = slot
        return slot, evicted


class ClockPolicy(CachePolicy):
    """Second-chance clock (reference ``ClockCachePolicy``, :579)."""

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self.ring: List[Optional[int]] = [None] * capacity
        self.ref: List[bool] = [False] * capacity
        self.hand = 0

    def lookup(self, key):
        slot = self.key_to_slot.get(key)
        if slot is not None:
            self.ref[slot] = True
        return slot

    def insert(self, key):
        if key in self.key_to_slot:
            slot = self.key_to_slot[key]
            self.ref[slot] = True
            return slot, None
        evicted = None
        if self.free:
            slot = self.free.pop()
        else:
            while True:
                if not self.ref[self.hand]:
                    slot = self.hand
                    evicted = self.ring[slot]
                    del self.key_to_slot[evicted]
                    self.hand = (self.hand + 1) % self.capacity
                    break
                self.ref[self.hand] = False
                self.hand = (self.hand + 1) % self.capacity
        self.key_to_slot[key] = slot
        self.ring[slot] = key
        self.ref[slot] = True
        return slot, evicted


class SievePolicy(CachePolicy):
    """SIEVE (reference ``SieveCachePolicy``, :389): FIFO with a visited bit
    and a stationary eviction hand."""

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self.queue: "OrderedDict[int, bool]" = OrderedDict()  # key -> visited

    def lookup(self, key):
        slot = self.key_to_slot.get(key)
        if slot is not None:
            self.queue[key] = True
        return slot

    def insert(self, key):
        if key in self.key_to_slot:
            self.queue[key] = True
            return self.key_to_slot[key], None
        evicted = None
        if self.free:
            slot = self.free.pop()
        else:
            # sweep from the tail (oldest): skip visited, clearing the bit
            while True:
                k, visited = next(iter(self.queue.items()))
                if visited:
                    self.queue[k] = False
                    self.queue.move_to_end(k)
                else:
                    evicted = k
                    del self.queue[k]
                    slot = self.key_to_slot.pop(k)
                    break
        self.key_to_slot[key] = slot
        self.queue[key] = False
        return slot, evicted


class S3FifoPolicy(CachePolicy):
    """S3-FIFO (reference ``S3FifoCachePolicy``, :256): small probationary
    FIFO + main FIFO + ghost queue of recently evicted keys."""

    def __init__(self, capacity: int, small_ratio: float = 0.1):
        super().__init__(capacity)
        self.small_cap = max(1, int(capacity * small_ratio))
        self.small: deque = deque()      # probationary keys
        self.main: deque = deque()       # main keys
        self.freq: Dict[int, int] = {}
        self.ghost: "OrderedDict[int, None]" = OrderedDict()
        self.ghost_cap = capacity

    def lookup(self, key):
        slot = self.key_to_slot.get(key)
        if slot is not None:
            self.freq[key] = min(self.freq.get(key, 0) + 1, 3)
        return slot

    def _evict_small(self):
        while self.small:
            k = self.small.popleft()
            if self.freq.get(k, 0) > 0:
                self.main.append(k)  # promote
                self.freq[k] = 0
            else:
                # evict to ghost
                self.ghost[k] = None
                if len(self.ghost) > self.ghost_cap:
                    self.ghost.popitem(last=False)
                return self.key_to_slot.pop(k), k
        return None

    def _evict_main(self):
        while self.main:
            k = self.main.popleft()
            if self.freq.get(k, 0) > 0:
                self.freq[k] -= 1
                self.main.append(k)
            else:
                return self.key_to_slot.pop(k), k
        return None

    def _evict(self):
        if len(self.small) >= self.small_cap:
            r = self._evict_small()
            if r is not None:
                return r
        r = self._evict_main()
        if r is not None:
            return r
        r = self._evict_small()
        if r is not None:
            return r
        raise RuntimeError("S3FIFO: nothing to evict")

    def insert(self, key):
        if key in self.key_to_slot:
            self.freq[key] = min(self.freq.get(key, 0) + 1, 3)
            return self.key_to_slot[key], None
        evicted = None
        if self.free:
            slot = self.free.pop()
        else:
            slot, evicted = self._evict()
        self.key_to_slot[key] = slot
        self.freq[key] = 0
        if key in self.ghost:
            del self.ghost[key]
            self.main.append(key)  # ghost hit -> straight to main
        else:
            self.small.append(key)
        return slot, evicted
