"""Prefetching host -> device input pipeline (the port of
emotiongestures_tpu/data/pipeline.py): a background thread assembles the
next batches while the card computes, stages each array in pinned host
memory and copies it to the card on a side CUDA stream, so the copy overlaps
the current batch's compute.

    with Prefetcher(dataset.batches(1024), device="cuda", buffer_size=2) as it:
        for batch in it:
            ...

Keys in `host_keys` (the raw audio, which only the host beat metric reads)
stay numpy. On the CPU the arrays become tensors without a copy.
`place_batches` is the synchronous form (`--prefetch 0`).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch


class _Placer:
    """numpy -> tensor on `device`; on CUDA through pinned memory and a side
    stream, with an event that the consumer's stream waits on."""

    def __init__(self, device, host_keys=()):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.host_keys = frozenset(host_keys)
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None

    def __call__(self, batch: dict) -> dict:
        out, arrays = {}, {}
        for k, v in batch.items():
            if not isinstance(v, np.ndarray):
                continue  # e.g. aux_info never reaches the device
            if k in self.host_keys:
                out[k] = v
            else:
                arrays[k] = torch.from_numpy(np.ascontiguousarray(v))
        if not self.cuda:
            out.update(arrays)
            return out
        with torch.cuda.stream(self.stream):
            for k, t in arrays.items():
                out[k] = t.pin_memory().to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        out["_ready"] = ready
        return out

    def claim(self, batch: dict) -> dict:
        """On the consumer's thread: make its stream wait for the copies and
        mark the tensors as used there (the allocator then keeps their
        memory until that stream is done with them)."""
        ready = batch.pop("_ready", None)
        if ready is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(ready)
            for v in batch.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(current)
        return batch


class Prefetcher:
    """Wrap a batch iterator; overlap host batch assembly and the
    host-to-device copy with the consumer's compute. Errors in the worker
    are raised in the consumer."""

    _DONE = object()

    def __init__(self, batches: Iterator[dict], device, buffer_size: int = 2,
                 host_keys=()):
        self.batches = batches
        self.place = _Placer(device, host_keys)
        self.q: queue.Queue = queue.Queue(maxsize=max(buffer_size, 1))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._started = False

    def _worker(self):
        try:
            if self.place.cuda:
                torch.cuda.set_device(self.place.device)
            for batch in self.batches:
                if self._stop.is_set():
                    break
                self.q.put(self.place(batch))
        except BaseException as e:  # raised again in the consumer
            self._err = e
        finally:
            self.q.put(self._DONE)

    def __enter__(self):
        if not self._started:
            self._thread.start()
            self._started = True
        return self

    def __exit__(self, *exc):
        if self._started:
            self._stop.set()
            # drain so that a worker blocked on a full queue can finish
            while self._thread.is_alive():
                try:
                    self.q.get(timeout=0.1)
                except queue.Empty:
                    pass
            self._thread.join(timeout=5)

    def __iter__(self):
        self.__enter__()
        while True:
            item = self.q.get()
            if item is self._DONE:
                if self._err is not None:
                    raise self._err
                return
            yield self.place.claim(item)


def place_batches(batches: Iterator[dict], device, host_keys=()):
    """Synchronous counterpart of Prefetcher (`--prefetch 0`): the same
    placement, one batch at a time, on the caller's thread."""
    place = _Placer(device, host_keys)
    for batch in batches:
        yield place.claim(place(batch))
