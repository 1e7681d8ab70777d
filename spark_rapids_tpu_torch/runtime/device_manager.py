"""Device acquisition and memory setup (port of
``spark_rapids_tpu/runtime/device_manager.py``; reference:
GpuDeviceManager.scala, which picks the GPU, sizes the RMM pool and
starts the pinned pool and the host limits).

Here: the CUDA device by ordinal, its budget from
``torch.cuda.mem_get_info``'s total x ``allocFraction`` less the
reserve, and the host arbiter, the pinned pool and the spill catalog's
host tier from the conf. On the CPU (``device="cpu"``, the tests) the
budget is the reference's default, so both packages' tests see one
number."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from spark_rapids_tpu_torch.conf import (
    DEVICE_ORDINAL,
    HBM_POOL_FRACTION,
    HBM_RESERVE_BYTES,
    HOST_MEMORY_LIMIT,
    HOST_SPILL_STORAGE_SIZE,
    PINNED_POOL_SIZE,
    RapidsConf,
)
from spark_rapids_tpu_torch.lockorder import ordered_lock

#: the reference's default device budget when no device reports one
_DEFAULT_HBM_BYTES = 16 << 30


@dataclass
class DeviceInfo:
    device: torch.device
    #: the device budget: total x allocFraction - reserve (at least
    #: 256 MiB); the reference's default on the CPU
    hbm_limit_bytes: int


class TpuDeviceManager:
    """Per-process device state (the reference's name)."""

    _instance: Optional["TpuDeviceManager"] = None
    _instance_lock = ordered_lock("device.manager.instance")

    def __init__(self, conf: RapidsConf, device=None):
        self.conf = conf
        self.device = None if device is None else torch.device(device)
        self.info: Optional[DeviceInfo] = None
        self.initialized = False

    def _select_device(self) -> torch.device:
        """The device the caller named, else the conf ordinal, else the
        current CUDA device."""
        want = int(self.conf.get_entry(DEVICE_ORDINAL))
        if self.device is not None and (self.device.type != "cuda"
                                        or want < 0):
            return self.device
        count = torch.cuda.device_count()
        if want >= 0:
            if want >= count:
                from spark_rapids_tpu_torch.errors import (
                    ColumnarProcessingError,
                )
                raise ColumnarProcessingError(
                    f"spark.rapids.tpu.deviceOrdinal={want} but only "
                    f"{count} CUDA devices exist")
            return torch.device("cuda", want)
        return torch.device("cuda", torch.cuda.current_device())

    def initialize(self) -> "TpuDeviceManager":
        if self.initialized:
            return self
        dev = self._select_device()
        frac = float(self.conf.get_entry(HBM_POOL_FRACTION))
        reserve = int(self.conf.get_entry(HBM_RESERVE_BYTES))
        if dev.type == "cuda":
            _, total = torch.cuda.mem_get_info(dev)
            limit = max(int(total * frac) - reserve, 256 << 20)
        else:
            limit = _DEFAULT_HBM_BYTES
        self.info = DeviceInfo(device=dev, hbm_limit_bytes=limit)
        from spark_rapids_tpu_torch.runtime.host_alloc import (
            HostMemoryArbiter,
            PinnedMemoryPool,
        )
        from spark_rapids_tpu_torch.runtime.spill import BufferCatalog
        BufferCatalog.get().host_limit_bytes = int(
            self.conf.get_entry(HOST_SPILL_STORAGE_SIZE))
        HostMemoryArbiter.reset(int(self.conf.get_entry(HOST_MEMORY_LIMIT)))
        PinnedMemoryPool.initialize(int(self.conf.get_entry(PINNED_POOL_SIZE)))
        with TpuDeviceManager._instance_lock:
            TpuDeviceManager._instance = self
        self.initialized = True
        return self

    @classmethod
    def current(cls) -> Optional["TpuDeviceManager"]:
        return cls._instance

    @classmethod
    def for_session(cls, conf: RapidsConf, device) -> "TpuDeviceManager":
        """The process's manager for ``device``, started again when the
        device or the conf it read changed (the runtime is process state,
        as in the reference)."""
        cur = cls._instance
        dev = torch.device(device)
        if (cur is not None and cur.device == dev
                and cur._conf_key() == cls._key_of(conf)):
            return cur
        return cls(conf, dev).initialize()

    @staticmethod
    def _key_of(conf: RapidsConf) -> tuple:
        return tuple(conf.get_entry(e) for e in (
            DEVICE_ORDINAL, HBM_POOL_FRACTION, HBM_RESERVE_BYTES,
            HOST_SPILL_STORAGE_SIZE, HOST_MEMORY_LIMIT, PINNED_POOL_SIZE))

    def _conf_key(self) -> tuple:
        return self._key_of(self.conf)

