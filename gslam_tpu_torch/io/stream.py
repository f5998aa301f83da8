"""Sensor streaming with back-pressure.

Counterpart of gslam_tpu/io/stream.py: a daemon thread iterates a dataset
into a bounded queue, so reading frames overlaps tracking.
"""

from __future__ import annotations

import queue
import threading


class SensorStream:
    """Iterates a dataset into a bounded queue from a background thread.

    `get()` returns Frames in order and None when the stream ends.
    """

    def __init__(self, dataset, maxsize: int = 10):
        self.dataset = dataset
        self.queue: queue.Queue = queue.Queue(maxsize=maxsize)
        self.thread = threading.Thread(target=self._run, daemon=True)
        self._stopped = threading.Event()

    def start(self):
        self.thread.start()
        return self

    def _run(self):
        self.dataset.init()
        try:
            for frame in iter(self.dataset):
                if self._stopped.is_set():
                    return
                while True:
                    try:
                        self.queue.put(frame, timeout=0.5)
                        break
                    except queue.Full:
                        if self._stopped.is_set():
                            return
        finally:
            self.queue.put(None)

    def get(self, timeout=None):
        return self.queue.get(timeout=timeout)

    def empty(self) -> bool:
        return self.queue.empty()

    def stop(self):
        self._stopped.set()
