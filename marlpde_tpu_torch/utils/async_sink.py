"""Asynchronous .npy writer (port of marlpde_tpu/utils/async_sink.py:72-121).

One writer thread drains a queue and calls ``np.save``, so the caller's loop
does not wait on the file system.  ``write`` copies the array and returns;
``flush`` is the barrier before reading the files.  The JAX package binds a
C++ writer built from the repository's root ``csrc/``; the port keeps its
interface (``write``, ``pending``, ``flush``, ``close``) and writes the bytes
``np.save`` writes.  Like the JAX sink, it stores dtypes other than float32,
float64, int32, int64 and uint8 as float32.

Usage:
    sink = AsyncSink(out_dir)
    sink.write("relError_3", np_array)     # returns at once
    ...
    sink.flush()                           # barrier before reading the files
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np

_DTYPES = tuple(np.dtype(d) for d in ("float32", "float64", "int32", "int64", "uint8"))


class AsyncSink:
    """Non-blocking .npy writer backed by one worker thread."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self._queue: queue.Queue = queue.Queue()
        self._error = None
        self._thread = threading.Thread(target=self._run, name="async-sink", daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            job = self._queue.get()
            try:
                if job is None:
                    return
                if self._error is None:
                    np.save(*job)
            except OSError as err:      # reported by the next flush
                self._error = err
            finally:
                self._queue.task_done()

    def write(self, name: str, array) -> None:
        if self._thread is None:
            raise RuntimeError("[async_sink] write after close")
        arr = np.array(array, order="C")          # a copy: the caller may reuse its buffer
        if arr.dtype not in _DTYPES:
            arr = arr.astype(np.float32)
        self._queue.put((os.path.join(self.out_dir, f"{name}.npy"), arr))

    def pending(self) -> int:
        """Writes queued or in progress."""
        return self._queue.unfinished_tasks

    def flush(self) -> None:
        """Wait until every queued write is on disk; raise the first write's error."""
        self._queue.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        if self._thread is None:
            return
        self._queue.put(None)
        self._thread.join()
        self._thread = None
        self.flush()

    def __del__(self):
        if getattr(self, "_thread", None) is not None:
            self._queue.put(None)
