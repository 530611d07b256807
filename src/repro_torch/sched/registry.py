"""Scheduler registry — resolve schedulers by name.

``register(name, factory)`` (or ``@register(name)`` as a decorator) binds a
name to a factory; ``create(name, **kwargs)`` instantiates one. The built-in
schedulers (gadget, fifo, drf, las and the beyond-paper elastic baseline
variants) self-register when their defining modules import, which
:func:`_ensure_builtin` triggers lazily — this module itself imports nothing
from repro_torch.core/repro_torch.cluster, so there is no import cycle.
"""

from __future__ import annotations

from typing import Callable, Dict, List


_REGISTRY: Dict[str, Callable] = {}


def register(name: str, factory: Callable = None):
    """Register a scheduler factory under ``name`` (callable or decorator).

    Factories take keyword arguments (at least ``seed``) and return a
    Scheduler. Re-registering a name overwrites it (idempotent reloads).
    """
    if factory is None:  # decorator form
        def _decorator(f: Callable) -> Callable:
            _REGISTRY[name] = f
            return f

        return _decorator
    _REGISTRY[name] = factory
    return factory


def _ensure_builtin() -> None:
    # importing the defining modules runs their register(...) calls
    import repro_torch.core.gadget  # noqa: F401
    import repro_torch.core.baselines  # noqa: F401


def available() -> List[str]:
    """Sorted names of every registered scheduler."""
    _ensure_builtin()
    return sorted(_REGISTRY)


def create(name: str, **kwargs):
    """Instantiate the scheduler registered under ``name``.

    The instance's ``name`` is stamped with the registry name, so variant
    registrations (``drf+elastic``, ``gadget-exact``, ...) stay
    distinguishable in ``SimResult.scheduler`` / ``metrics.summarize`` rows
    instead of collapsing onto their base class's name.
    """
    _ensure_builtin()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown scheduler {name!r}; available: {', '.join(available())}"
        )
    sched = _REGISTRY[name](**kwargs)
    sched.name = name
    return sched
