"""Small caching utilities.

Reference counterparts: ``common/LRUCache.java`` (LinkedHashMap LRU) and the
facade's ``StringKeyedCache`` expiring query cache
(api/ForwardSecureANNSystem.java:1103-1151).
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Generic, Hashable, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")


class LRUCache(Generic[K, V]):
    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be > 0")
        self.capacity = capacity
        self._d: OrderedDict[K, V] = OrderedDict()

    def get(self, key: K, default=None):
        try:
            self._d.move_to_end(key)
            return self._d[key]
        except KeyError:
            return default

    def put(self, key: K, value: V) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: K) -> bool:
        return key in self._d


class ExpiringCache(Generic[K, V]):
    """LRU + TTL — the query-result cache shape.  Keys are typically the
    query-vector bytes digest; values the search results."""

    def __init__(self, capacity: int = 1024, ttl_s: float = 60.0):
        self.ttl_s = ttl_s
        self._lru: LRUCache[K, tuple[float, V]] = LRUCache(capacity)
        self.hits = 0
        self.misses = 0

    def get(self, key: K, default=None):
        entry = self._lru.get(key)
        if entry is None:
            self.misses += 1
            return default
        ts, value = entry
        if time.monotonic() - ts > self.ttl_s:
            self.misses += 1
            return default
        self.hits += 1
        return value

    def put(self, key: K, value: V) -> None:
        self._lru.put(key, (time.monotonic(), value))
