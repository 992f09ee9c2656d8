"""Stage-service runtime: daemon-thread pipeline stages with bounded
queues (a copy of the JAX package's runtime, which imports no JAX).

The reference runs each pipeline stage in a torch.multiprocessing daemon
process with CUDA-shared-memory tensor handoff (src/upscale/
base_service.py:10-122, pipeline.py:91-93). Here a stage is a daemon
*thread* with the same bounded-queue interface: frames cross stages as
NumPy arrays or tensors with zero IPC copies, and the GIL is released
inside the ffmpeg pipe reads and the CUDA calls (the only hot code).

API parity with BaseService: start / push_job(entry, timeout) /
push_job_nowait / get_result / stop / join / wait_for_job_clear,
overridables proc_init / proc_job_recieved / proc_cleanup, `on_queue`
chaining (runs on the producing stage's thread, pushing into the next
stage's queue), `exit_on_error` fail-fast, and dead-worker detection
(ServiceDeadException <- ProcessDeadException, base_service.py:72-85).

Improvement over the reference: a real EOF protocol. `EOF` is a class
sentinel; `push_eof()` enqueues it, the worker loop runs proc_cleanup and
exits after forwarding it, so shutdown drains the pipe instead of the
reference's unreachable 'TODO: finish pipeline until None reach to the
end' (pipeline.py:76).
"""

from __future__ import annotations

import os
import queue
import signal
import threading
import time
import traceback
from typing import Any, Callable, Optional

__all__ = ["BaseService", "ServiceDeadException", "EOF"]


class ServiceDeadException(Exception):
    """Raised by check_proc()/push/get when the worker thread has died."""


class EOF:
    """End-of-stream sentinel. Forwarded downstream, then the stage exits."""

    def __repr__(self) -> str:  # pragma: no cover
        return "<EOF>"


EOF_SENTINEL = EOF()
_EXIT = object()


class BaseService:
    on_queue: Optional[Callable[[Any], None]] = None
    exit_on_error: bool = False
    poll_interval: float = 0.001  # reference sleeps 1 ms between polls

    def __init__(
        self,
        job_queue_size: int = 32,
        result_queue_size: int = 32,
        name: str | None = None,
    ) -> None:
        self.job_queue: queue.Queue = queue.Queue(maxsize=job_queue_size)
        self.result_queue: queue.Queue = queue.Queue(maxsize=result_queue_size)
        # jobs a proc_job_recieved override pulled ahead (coalescing) but
        # could not use — consumed before job_queue, preserving order
        self._stash: list = []
        self.name = name or type(self).__name__
        # made by start(): a thread that refers to the service, made here,
        # would keep a service that never starts (and the device memory
        # it holds) alive until the cycle collector runs
        self._thread: threading.Thread | None = None
        self._started = False
        self._dead = False
        self._error: BaseException | None = None
        self._eof_seen = threading.Event()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._started = True
        self._thread = threading.Thread(
            target=self._thread_main, daemon=True, name=self.name
        )
        self._thread.start()

    def stop(self) -> None:
        """Graceful exit: unblocks the worker even mid-queue."""
        if not self._started:
            return
        try:
            self.job_queue.put_nowait(_EXIT)
        except queue.Full:
            # drain one slot so the exit token always fits
            try:
                self.job_queue.get_nowait()
            except queue.Empty:
                pass
            self.job_queue.put_nowait(_EXIT)
        self.join()

    def push_eof(self) -> None:
        """Enqueue the end-of-stream sentinel (blocking — EOF must not drop)."""
        self.job_queue.put(EOF_SENTINEL)

    def join(self, timeout: float | None = 15) -> None:
        if self._started:
            self._thread.join(timeout=timeout)

    @property
    def is_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def check_proc(self) -> None:
        if self._started and self._dead:
            if self.exit_on_error:
                traceback.print_exception(self._error)
                os.kill(os.getpid(), signal.SIGINT)
            raise ServiceDeadException(
                f"{self.name}: worker died: {self._error!r}"
            )

    # -- queue interface ----------------------------------------------------

    def push_job(self, entry: Any, timeout: float = 10) -> None:
        self.check_proc()
        self.job_queue.put(entry, timeout=timeout)

    def push_job_nowait(self, entry: Any) -> None:
        self.check_proc()
        self.job_queue.put_nowait(entry)

    def get_result(self, timeout: float = 10) -> Any:
        self.check_proc()
        return self.result_queue.get(timeout=timeout)

    def wait_for_job_clear(self) -> None:
        while self._stash or not self.job_queue.empty():
            time.sleep(self.poll_interval)

    def wait_eof(self, timeout: float | None = None) -> bool:
        """Block until the EOF sentinel has passed through this stage."""
        return self._eof_seen.wait(timeout)

    # -- worker ---------------------------------------------------------------

    def _deliver(self, entry: Any) -> None:
        if self.on_queue is not None:
            self.on_queue(entry)
        else:
            try:
                self.result_queue.put_nowait(entry)
            except queue.Full:
                print(
                    f"{self.name}: result queue full. Is the consumer "
                    "not fast enough?"
                )

    def _thread_main(self) -> None:
        try:
            self.proc_init()
            while True:
                if self._stash:
                    job = self._stash.pop(0)
                else:
                    try:
                        job = self.job_queue.get(timeout=self.poll_interval)
                    except queue.Empty:
                        # idle tick: stages with internal pipelining (e.g.
                        # the upscaler's in-flight device ring) drain here
                        # so a lone request is never parked on a successor
                        for entry in self.proc_idle():
                            self._deliver(entry)
                        continue
                if job is _EXIT:
                    break
                if isinstance(job, EOF):
                    # drain any in-flight state (e.g. the BSVD denoiser's
                    # SHIFT_NUM lookahead frames) before the sentinel
                    for entry in self.proc_eof():
                        self._deliver(entry)
                    self._deliver(job)
                    self._eof_seen.set()
                    break
                entry = self.proc_job_recieved(job)
                if isinstance(entry, list):
                    for e in entry:
                        self._deliver(e)
                elif entry is not None:
                    self._deliver(entry)
        except BaseException as ex:  # noqa: BLE001 — reported via check_proc
            self._error = ex
            self._dead = True
            if self.exit_on_error:
                traceback.print_exc()
                os.kill(os.getpid(), signal.SIGINT)
            else:
                # fail-open shutdown: forward EOF downstream and mark our
                # own EOF so pipeline join()/wait_eof() unblocks instead
                # of hanging forever on a dead stage; the error itself
                # stays visible through check_proc()/ServiceDeadException
                try:
                    self._deliver(EOF_SENTINEL)
                except BaseException:  # noqa: BLE001 — downstream may be dead too
                    pass
                self._eof_seen.set()
                raise
        finally:
            self._dead = self._error is not None
            try:
                self.proc_cleanup()
            except Exception:  # pragma: no cover
                traceback.print_exc()

    # -- overridables -----------------------------------------------------------

    def proc_init(self) -> None:
        pass

    def proc_job_recieved(self, job: Any) -> Any:
        return job

    def proc_eof(self):
        """Entries to deliver when the EOF sentinel arrives, before it is
        forwarded — override to drain in-flight state (default: none)."""
        return ()

    def proc_idle(self):
        """Entries to deliver when the job queue is momentarily empty —
        override to flush internally pipelined work (default: none)."""
        return ()

    def proc_cleanup(self) -> None:
        pass
