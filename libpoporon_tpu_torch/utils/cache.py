"""Bounded LRU cache for construction-time structures.

A copy of libpoporon_tpu/utils/cache.py.  Codec structure objects (RS
bit matrices and tables) are derived deterministically from their
config and reused across codec instances.  A long-lived service
sweeping configs must not grow these caches without bound, so they are
LRU-bounded.
"""

from __future__ import annotations

from collections import OrderedDict
from threading import Lock
from typing import Callable, TypeVar

K = TypeVar("K")
V = TypeVar("V")


class LruCache:
    """Thread-safe bounded LRU mapping with get_or_build semantics."""

    def __init__(self, capacity: int = 16):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._d: OrderedDict = OrderedDict()
        self._lock = Lock()

    def get_or_build(self, key: K, build: Callable[[], V]) -> V:
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                return self._d[key]
        # build outside the lock (construction can take seconds); a
        # concurrent duplicate build is harmless — results are
        # deterministic and the second insert wins
        val = build()
        with self._lock:
            self._d[key] = val
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)
        return val

    def __len__(self) -> int:
        return len(self._d)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
