"""Executor-process entry point: ``python -m
spark_rapids_tpu_torch.runtime.cluster_exec`` (port of
``spark_rapids_tpu/runtime/cluster_exec.py``).

A module of its own on purpose: running ``runtime/cluster.py`` itself with
``-m`` would execute it as ``__main__`` AND import it again from the scan
path, two module instances with two registries. This shim holds no
state."""

from spark_rapids_tpu_torch.runtime.cluster import executor_main

if __name__ == "__main__":
    raise SystemExit(executor_main())
