"""Runtime services of the port: speculative sizing, and the memory
runtime (the device manager, the device budget, the spill catalog, the
OOM retry framework, the host arbiter and pinned pool, the task semaphore
and the placement layer's drain)."""
