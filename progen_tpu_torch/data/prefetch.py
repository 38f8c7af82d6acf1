"""Double-buffered host-to-device input feed (ported from
progen_tpu/data/prefetch.py).

:class:`DevicePrefetcher` moves the feed off the step's critical path: a
daemon thread pulls host batches and starts their copy to the device while
the current step runs, keeping ``depth`` batches in flight.

On a CUDA device the worker copies each batch into pinned host memory and
issues the host-to-device copy on a side ``torch.cuda.Stream``, recording
an event after it.  The consumer makes its current stream wait on that
event (so no kernel reads the batch before the copy lands) and calls
``record_stream`` on the tensor (so the caching allocator does not hand its
memory to another tensor while a step queued on the consumer's stream may
still read it).  Elsewhere the worker applies ``to_device``.

:class:`SuperbatchStager` feeds the superstep loop
(``train/step.py:train_multi_step``): a ``DevicePrefetcher`` with an
identity transform keeps the host micro-batches pulled ahead, and each
``get(k)`` stacks the next ``k * accum`` of them into one fresh
``(k, accum, B, L)`` array.  On a card the stack is written straight into
pinned host memory and copied with ``non_blocking=True``, so the copy runs
while the replays already queued on the stream run.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator

import numpy as np
import torch


class _End:
    pass


class _Raised:
    def __init__(self, exc: BaseException):
        self.exc = exc


class _Staged:
    """A batch whose copy to the card was issued on a side stream."""

    def __init__(self, tensor: torch.Tensor, copied: torch.cuda.Event):
        self.tensor = tensor
        self.copied = copied


class DevicePrefetcher:
    """Wrap ``iterator`` so host-to-device copies overlap step execution.

    Give ``to_device`` (host batch -> device value) or ``device``: a CUDA
    ``device`` takes the pinned-memory side-stream copy, a CPU one a plain
    ``torch.from_numpy``.  ``depth``: batches buffered ahead (2 = double
    buffering).
    """

    def __init__(
        self,
        iterator: Iterator[Any],
        to_device: Callable[[Any], Any] | None = None,
        depth: int = 2,
        device: torch.device | str | None = None,
    ):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if (to_device is None) == (device is None):
            raise ValueError("give exactly one of to_device and device")
        self._device = None if device is None else torch.device(device)
        self._cuda = self._device is not None and self._device.type == "cuda"
        if self._device is not None and not self._cuda:
            to_device = lambda batch: torch.from_numpy(np.asarray(batch)).to(self._device)
        self._to_device = to_device
        self._copy_stream = torch.cuda.Stream(self._device) if self._cuda else None
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._iterator = iterator
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, name="progen-prefetch", daemon=True
        )
        self._thread.start()

    def _stage(self, batch) -> _Staged:
        host = torch.from_numpy(np.asarray(batch)).pin_memory()
        with torch.cuda.stream(self._copy_stream):
            tensor = host.to(self._device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._copy_stream)
        return _Staged(tensor, copied)

    def _worker(self) -> None:
        try:
            while not self._stop.is_set():
                try:
                    batch = next(self._iterator)
                except StopIteration:
                    self._put(_End())
                    return
                self._put(self._stage(batch) if self._cuda else self._to_device(batch))
        except BaseException as e:  # surfaced on the consumer thread
            self._put(_Raised(e))

    def _put(self, item) -> None:
        # bounded put that gives up when the consumer is shutting down
        # (otherwise a full queue would wedge the daemon thread forever)
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, _End):
            raise StopIteration
        if isinstance(item, _Raised):
            raise item.exc
        if isinstance(item, _Staged):
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(item.copied)
            item.tensor.record_stream(stream)
            return item.tensor
        return item

    def close(self) -> None:
        """Stop the worker and drop buffered batches (idempotent).

        The wrapped iterator is OWNED by the prefetcher from construction
        on: the worker may be blocked inside ``next(iterator)``, in which
        case it survives the bounded join as an orphaned daemon and may
        still consume one more item when the source unblocks.  Never hand
        the underlying iterator to another consumer after wrapping it."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)
        if self._thread.is_alive():
            import warnings

            warnings.warn(
                "DevicePrefetcher worker did not exit within 5s (blocked in "
                "next() on the wrapped iterator?); it remains attached to "
                "the iterator and may consume one more batch",
                RuntimeWarning,
                stacklevel=2,
            )


class SuperbatchStager:
    """Stage ``(k, accum, B, L)`` superbatches for the superstep loop
    (ported from ``progen_tpu/data/prefetch.py:SuperbatchStager``).

    A background thread keeps up to ``depth`` supersteps' worth of host
    micro-batches pulled ahead (a :class:`DevicePrefetcher` with an identity
    transform as the host-side buffer); :meth:`get` stacks the next
    ``k * accum`` of them into one new array and hands it to ``to_device``,
    or with ``device`` (instead of ``to_device``) copies it there: to a
    CUDA device from pinned memory without waiting, to the CPU as a tensor.
    Every ``get`` returns a fresh buffer.

    ``k`` may vary per call (the trainer shrinks the span before a hook
    boundary) up to the ``k_max`` the stager was sized for.
    """

    def __init__(self, iterator: Iterator[Any], to_device: Callable[[Any], Any] | None = None,
                 accum: int = 1, k_max: int = 1, depth: int = 2,
                 device: torch.device | str | None = None):
        if accum < 1:
            raise ValueError(f"accum must be >= 1, got {accum}")
        if k_max < 1:
            raise ValueError(f"k_max must be >= 1, got {k_max}")
        if (to_device is None) == (device is None):
            raise ValueError("give exactly one of to_device and device")
        self._accum = accum
        self._k_max = k_max
        self._to_device = to_device
        self._device = None if device is None else torch.device(device)
        self._host = DevicePrefetcher(iterator, lambda batch: batch,  # host-side buffering only
                                      depth=max(1, depth) * k_max * accum)

    def get(self, k: int):
        """The next ``k`` optimizer steps' data as one ``(k, accum, B, L)``
        array on the device (its copy may still be in flight on a card).
        Raises ``StopIteration`` when the wrapped iterator cannot supply a
        full superbatch (the trainer feeds a looping stream, so this only
        surfaces on finite iterators)."""
        if not 1 <= k <= self._k_max:
            raise ValueError(f"k must be in [1, {self._k_max}], got {k}")
        micro = [np.asarray(next(self._host)) for _ in range(k * self._accum)]
        shape = (k, self._accum) + micro[0].shape
        if self._device is None:
            return self._to_device(np.stack(micro).reshape(shape))
        if self._device.type != "cuda":
            return torch.from_numpy(np.stack(micro).reshape(shape)).to(self._device)
        pinned = torch.empty(shape, dtype=torch.from_numpy(micro[0]).dtype, pin_memory=True)
        np.stack(micro, out=pinned.numpy().reshape((-1,) + micro[0].shape))
        return pinned.to(self._device, non_blocking=True)

    def close(self) -> None:
        """Stop the host prefetch worker and drop buffered batches."""
        self._host.close()
