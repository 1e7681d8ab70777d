"""Named locks (a minimal copy of ``spark_rapids_tpu/lockorder.py``'s
factories).

The reference constructs every lock of its runtime through these
factories so that a declared rank hierarchy and an opt-in runtime
witness can check the acquisition order. The port keeps the factory
names, so each lock carries the reference's name at its construction
site, and returns plain ``threading`` objects: the rank table, the
witness and the lint rule over them are not ported yet.
"""

from __future__ import annotations

import threading


def ordered_lock(name: str) -> threading.Lock:
    """A non-reentrant lock named ``name``."""
    del name
    return threading.Lock()


def ordered_rlock(name: str) -> threading.RLock:
    """A reentrant lock named ``name``."""
    del name
    return threading.RLock()


def ordered_condition(name: str) -> threading.Condition:
    """A condition (over its own reentrant lock) named ``name``."""
    del name
    return threading.Condition(threading.RLock())
