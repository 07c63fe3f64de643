"""Shared worker event loop: one asyncio loop thread for sync callers.

Counterpart of the JAX package's ``parallel/aio.py``. The scoring engine
is asyncio-native, but most entry points are synchronous: rather than each
caller running a private ``asyncio.run`` (which would tear the engine down
between calls), one process-wide daemon loop thread hosts long-lived async
components, and sync code submits coroutines to it. Stdlib only.
"""

import asyncio
import threading
from typing import Optional

_lock = threading.Lock()
_shared: Optional["LoopThread"] = None


class LoopThread:
    """An asyncio event loop running on a dedicated daemon thread."""

    def __init__(self, name: str = "tip-aio"):
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, name=name, daemon=True
        )
        self._thread.start()

    @property
    def loop(self) -> asyncio.AbstractEventLoop:
        """The underlying event loop (for advanced callers)."""
        return self._loop

    def submit(self, coro):
        """Schedule ``coro`` on the loop; returns a concurrent Future."""
        return asyncio.run_coroutine_threadsafe(coro, self._loop)

    def run(self, coro, timeout: Optional[float] = None):
        """Run ``coro`` to completion from sync code (blocks the caller,
        never the loop). ``timeout`` bounds the wait in seconds."""
        return self.submit(coro).result(timeout)

    def stop(self) -> None:
        """Stop the loop and join the thread (idempotent)."""
        if self._loop.is_closed():
            return
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=5.0)
        if not self._loop.is_running():
            self._loop.close()


def shared_loop() -> LoopThread:
    """The process-wide shared loop thread (created on first use)."""
    global _shared
    with _lock:
        if _shared is None or _shared.loop.is_closed():
            _shared = LoopThread()
        return _shared
