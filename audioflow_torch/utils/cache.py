"""Bounded, thread-safe LRU cache for host-side design constants.

The ops modules precompute DFT/kernel/dual banks host-side (float64 design,
f32 shipping) keyed on the op's static parameters. Those banks can reach
multi-MB per entry (a CQT dual bank at 84 bins/16 kHz is ~11 MB), and
long-lived processes (sessions, sweeps touching many configs) must not grow
them without bound — reference parity: the reference app never caches design
state at all (it redesigns per stream), so ANY bound here is strictly ahead.

``BoundedCache`` is dict-shaped on purpose: call sites keep their natural
``if key in cache: return cache[key]`` form. The get/set race that form
allows is benign — both racers compute the identical (deterministic,
parameter-keyed) value and the second store wins with equal data — while the
lock protects the OrderedDict's internal state, which IS what breaks under
unsynchronized mutation (the repo's thread-safety tests hammer this).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Hashable

import numpy as np
import torch


class BoundedCache:
    """A locked LRU mapping with a fixed entry bound.

    Reads refresh recency; writes evict the least-recently-used entry once
    ``maxsize`` is exceeded. ``maxsize`` bounds entry COUNT, not bytes —
    design banks for one config family are same-order sized, so a count
    bound is an effective memory bound without weighing arrays on every put.
    """

    def __init__(self, maxsize: int = 32):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self._data: OrderedDict[Hashable, Any] = OrderedDict()
        self._lock = threading.Lock()

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._data

    def __getitem__(self, key: Hashable) -> Any:
        with self._lock:
            value = self._data[key]
            self._data.move_to_end(key)
            return value

    def __setitem__(self, key: Hashable, value: Any) -> None:
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)

    def get(self, key: Hashable, default: Any = None) -> Any:
        with self._lock:
            if key not in self._data:
                return default
            self._data.move_to_end(key)
            return self._data[key]

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()


# device copies of host-designed constants, ~n_fft*(n_fft//2+1)*4 B each
_DEVICE_CACHE = BoundedCache(maxsize=64)


def on_device(array: np.ndarray, device: torch.device | str, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``array`` as a ``dtype`` (float32) tensor on ``device``, uploaded once per device.

    For the cached host designs (plans, banks, filterbanks): a stream step
    would otherwise upload every bank again, and an upload from pageable host
    memory makes the host wait for the device. Entries are keyed by the
    array's identity and hold the array itself, so an id cannot be reused
    while its entry lives. The tensors are shared and must not be written to.
    """
    key = (id(array), str(torch.device(device)), dtype)
    hit = _DEVICE_CACHE.get(key)
    if hit is None or hit[0] is not array:
        hit = (array, torch.tensor(np.asarray(array), dtype=dtype, device=device))
        _DEVICE_CACHE[key] = hit
    return hit[1]
