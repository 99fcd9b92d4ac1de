"""LoraPool: a fixed-slot device stack of adapters, paged from a host roster.

Port of `dynamo_tpu/models/lora_pool.py`. The device stack (models/lora.py
layout) holds a FIXED number of slots, `slots` + the all-zero base slot 0,
so adapter churn never changes an operand's shape. Adapters page between
the host roster and the device slots on demand:

  * LRU eviction over UNPINNED slots only: a slot pins its adapter for the
    life of every stream using it, so eviction never touches what an
    in-flight stream reads;
  * refuse-newest: when every slot is pinned, a cold acquire refuses with a
    typed LoraPoolError (counted) instead of queueing;
  * an onboard-latency EWMA (`lora_pool_onboard_ewma_ms`) prices a cold
    switch;
  * the `lora.onboard` fault point (runtime/faults.py) bites at the
    onboard: `error` refuses the acquire (counted), `delay` stretches the
    copy in land().

An onboard is split in two. `acquire` (and `register`) do the bookkeeping
at once: the adapter gets its slot, and its rows are queued. `land()`
writes the queued rows into the live stack in place, so the engine's
reference to the stack stays valid; the engine runs it on its device
thread, in order before every later dispatch, so the caller's thread never
waits for a copy. On CUDA the rows travel through pinned memory on the
device thread's current stream, where they land after every dispatch
queued before them and before every dispatch queued after. A rebuild (the
largest rank grew) installs fresh tensors at once and queues every
resident adapter again, keeping each in its slot where the reference's
re-numbers them: a pinned stream's index stays valid.

Counters (engine stats(), runtime/metrics.py): lora_pool_hits / misses /
evictions / refusals / onboard_ms / onboard_count and the slot gauges.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

import torch

from . import lora as lora_mod


class LoraPoolError(ValueError):
    """Typed adapter-tier refusal (unknown adapter, pinned-full pool, or an
    injected onboard fault): the caller rejects the request up front."""


class LoraPool:
    """Fixed-slot device stack + host adapter roster.

    `stack` is the engine-facing dict ({"a", "b", "scale", "names"}) in the
    layout `lora.stack_adapters` returns, one object for the pool's life;
    `names` maps each RESIDENT adapter to its device slot. The whole roster
    is `known_names()`."""

    def __init__(self, model_config, adapters, slots: int = 8, device="cpu"):
        self.model_config = model_config
        self.slots = max(1, int(slots))
        self.device = torch.device(device)
        self._host: "OrderedDict[str, lora_mod.LoraAdapter]" = OrderedDict()
        self._resident: Dict[str, int] = {}  # name -> device slot (1..slots)
        self._pins: Dict[str, int] = {}  # name -> live-stream refcount
        self._lru: "OrderedDict[str, None]" = OrderedDict()  # resident order
        self._free: List[int] = list(range(1, self.slots + 1))
        self._landing: "deque[tuple]" = deque()  # (name, slot, delay) to write
        self._stack_lock = threading.Lock()  # a rebuild's swap vs land()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.refusals = 0
        self.onboard_ms_sum = 0.0
        self.onboard_count = 0
        self._onboard_ewma_ms: Optional[float] = None
        self._r_max = 1
        self.stack = None
        self.register(adapters)

    # -- roster ---------------------------------------------------------- #

    def register(self, adapters) -> None:
        """Add adapters to the host roster (a name registered again is
        replaced). The device stack is rebuilt only when the largest rank
        grows; the first `slots` names are onboarded at once, so a small
        roster is servable without a cold switch."""
        for ad in adapters:
            self._host[ad.name] = ad
        r_max = max([a.rank for a in self._host.values()], default=1)
        if self.stack is None or r_max > self._r_max:
            self._r_max = r_max
            self._rebuild_stack()
        for name in list(self._host):
            if len(self._resident) >= self.slots:
                break
            if name not in self._resident:
                self._onboard(name)

    def _rebuild_stack(self) -> None:
        """A fresh all-zero stack at the current rank; each resident adapter
        is queued to land again in the slot it held. The fill is queued on
        the current stream, ahead of the copies that land() queues."""
        fresh = lora_mod.empty_stack(self.model_config, self.slots + 1, self._r_max,
                                     self.device)
        with self._stack_lock:
            if self.stack is None:
                self.stack = fresh
            else:
                fresh["names"] = self.stack["names"]
                self.stack.update(fresh)
        for name, slot in self._resident.items():
            self._landing.append((name, slot, False))

    def known_names(self) -> List[str]:
        return list(self._host)

    # -- paging ---------------------------------------------------------- #

    def land(self) -> None:
        """Write every queued adapter into its slot: its rows of every
        target's A and B, and its scale. Runs on the thread that queues the
        dispatches (the engine's device thread), so a later dispatch reads
        the rows; on CUDA the copies are queued from pinned memory and not
        waited for (the pinned sources live until they have run)."""
        on_cuda = self.device.type == "cuda"
        while self._landing:
            name, slot, delay = self._landing.popleft()
            t0 = time.perf_counter()
            if delay:
                time.sleep(0.05)
            ad = self._host[name]
            with self._stack_lock:
                stack = self.stack
                for t in lora_mod.TARGETS:
                    if t in ad.a:
                        A, B = lora_mod.padded(ad, t, self._r_max)
                        if on_cuda:
                            A, B = A.pin_memory(), B.pin_memory()
                        stack["a"][t][:, :, slot, :].copy_(A, non_blocking=on_cuda)
                        stack["b"][t][:, slot, :, :].copy_(B, non_blocking=on_cuda)
                    else:
                        stack["a"][t][:, :, slot, :].zero_()
                        stack["b"][t][:, slot, :, :].zero_()
                stack["scale"][slot] = ad.scale
            ms = (time.perf_counter() - t0) * 1000.0
            self.onboard_ms_sum += ms
            self._onboard_ewma_ms = (
                ms if self._onboard_ewma_ms is None
                else 0.8 * self._onboard_ewma_ms + 0.2 * ms
            )

    def landing(self) -> bool:
        """Whether rows wait for land()."""
        return bool(self._landing)

    def _onboard(self, name: str) -> int:
        """Give one host adapter a free device slot and queue its rows for
        land() (faults priced like kvbm.onboard). Raises LoraPoolError on
        an injected `error`."""
        from ..runtime import faults

        f = faults.FAULTS
        act = f.check("lora.onboard") if f.enabled else None
        if act == "error":
            self.refusals += 1
            raise LoraPoolError(
                f"adapter {name!r} onboard failed (injected); retry or "
                "route to a replica with the adapter resident"
            )
        slot = self._free.pop()
        self._resident[name] = slot
        self._lru[name] = None
        self.stack["names"][name] = slot
        self._landing.append((name, slot, act == "delay"))
        self.onboard_count += 1
        return slot

    def _evict_one(self) -> bool:
        """Drop the least recently used UNPINNED resident adapter."""
        for name in list(self._lru):
            if self._pins.get(name, 0) > 0:
                continue
            slot = self._resident.pop(name)
            self._lru.pop(name)
            self.stack["names"].pop(name, None)
            self._free.append(slot)
            self.evictions += 1
            return True
        return False

    def acquire(self, name: str) -> int:
        """Resolve `name` to its device slot, onboarding on a miss, and pin
        it for one live stream (one release() per acquire)."""
        if name not in self._host:
            raise LoraPoolError(
                f"unknown LoRA adapter {name!r}; available: "
                f"{sorted(self._host)}"
            )
        slot = self._resident.get(name)
        if slot is not None:
            self.hits += 1
        else:
            self.misses += 1
            if not self._free and not self._evict_one():
                self.refusals += 1
                raise LoraPoolError(
                    f"adapter pool full ({self.slots} slots, all pinned by "
                    f"live streams); retry adapter {name!r} later"
                )
            slot = self._onboard(name)
        self._lru.move_to_end(name)
        self._pins[name] = self._pins.get(name, 0) + 1
        return slot

    def release(self, name: str) -> None:
        n = self._pins.get(name, 0)
        if n <= 1:
            self._pins.pop(name, None)
        else:
            self._pins[name] = n - 1

    def pinned(self) -> int:
        """Live pins over all adapters (a leak shows here)."""
        return sum(self._pins.values())

    def stats(self) -> dict:
        out = {
            "lora_pool_slots": self.slots,
            "lora_pool_resident": len(self._resident),
            "lora_pool_known": len(self._host),
            "lora_pool_hits": self.hits,
            "lora_pool_misses": self.misses,
            "lora_pool_evictions": self.evictions,
            "lora_pool_refusals": self.refusals,
            "lora_pool_onboard_ms": round(self.onboard_ms_sum, 3),
            "lora_pool_onboard_count": self.onboard_count,
        }
        if self._onboard_ewma_ms is not None:
            out["lora_pool_onboard_ewma_ms"] = round(self._onboard_ewma_ms, 3)
        return out
