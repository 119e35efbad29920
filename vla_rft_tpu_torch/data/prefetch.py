"""Background batch prefetcher (port of vla_rft_tpu/data/prefetch.py).

One producer thread keeps a small queue of batches ahead of the trainer, so
the host prepares batch t + 1 while the device runs step t.  An error in the
producer (StopIteration included) reaches the consumer at the batch where it
happened, instead of leaving it waiting.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict


class PrefetchingLoader:
    """Wraps any object with next_batch() / state_dict() / load_state_dict()."""

    def __init__(self, inner, buffer_size: int = 2):
        self.inner = inner
        self._q: queue.Queue = queue.Queue(maxsize=buffer_size)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        while not self._stop.is_set():
            try:
                item = (self.inner.next_batch(), None)
            except Exception as e:  # handed to the consumer, which raises it
                item = (None, e)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if item[1] is not None:
                return

    def next_batch(self) -> Dict[str, Any]:
        batch, err = self._q.get()
        if err is not None:
            raise err
        return batch

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, state):
        self.inner.load_state_dict(state)

    def close(self):
        """Stop the producer and wait for it, up to 5 s (a next_batch() in
        progress runs to its end first)."""
        self._stop.set()
        self._thread.join(5.0)
