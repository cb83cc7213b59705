"""Host -> device input pipeline: the port of
``lifelong_nnunet_tpu/data/pipeline.py``.

A background thread draws host batches from the sampler and copies them to
the explicit device ahead of the train step: on a CUDA device from pinned
host memory with a ``non_blocking`` copy on a stream of its own, which the
consumer's stream waits for before it reads the batch.  Augmentation runs
on the device inside the train step (``augment.py``), so one thread and a
queue of depth 2 keep the device fed.  Under data parallelism each rank's
sampler yields only that rank's rows of the global batch, so each rank's
prefetcher moves only those.

Spans and counters (``tracing.py``): ``prefetch.h2d`` on the thread, the
pinning and the copy's enqueue, and ``prefetch.wait`` in ``next()``, the
queue's get and the stream wait, each carrying the batch's number (its
place in the queue, counted from 0); counters ``prefetch.next`` (calls of
``next()``) and ``prefetch.empty`` (calls that found the queue empty).
"""

from __future__ import annotations

import itertools
import queue
import threading

import torch

from .. import tracing


class Prefetcher:
    """Wraps a sampler's ``next_batch()``; ``next()`` returns ({"data",
    "seg"} on ``device``, keys)."""

    def __init__(self, sampler, device: torch.device, depth: int = 2):
        self.sampler = sampler
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._taken = 0             # batches handed out by next()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _put(self, arr) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if not self.cuda:
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _worker(self):
        for seq in itertools.count():
            if self._stop.is_set():
                return
            try:
                batch = self.sampler.next_batch()
                with tracing.span("prefetch.h2d", batch=seq):
                    if self.cuda:
                        with torch.cuda.stream(self.stream):
                            dev = {k: self._put(batch[k]) for k in ("data", "seg")}
                            ready = torch.cuda.Event()
                            ready.record(self.stream)
                    else:
                        dev, ready = {k: self._put(batch[k]) for k in ("data", "seg")}, None
                item = (dev, batch.get("keys"), ready)
            except Exception as e:        # surfaced to the consumer by next()
                item = e
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if isinstance(item, Exception):
                return

    def next(self):
        tracing.count("prefetch.next")
        tracing.count("prefetch.empty", self.q.empty())
        with tracing.span("prefetch.wait", batch=self._taken):
            item = self.q.get()
            if isinstance(item, Exception):
                raise item
            self._taken += 1
            dev, keys, ready = item
            if ready is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(ready)
                for t in dev.values():
                    t.record_stream(stream)
        return dev, keys

    def __next__(self):
        return self.next()

    def stop(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout=5)
