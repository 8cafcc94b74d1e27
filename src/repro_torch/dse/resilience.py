"""Fault-tolerant campaign execution: retries, timeouts, quarantine.

:func:`repro.dse.campaign.run_campaign` used to call ``fut.result()``
bare — one bad cell threw away every in-flight cell and left no
diagnosis behind. This module is the execution layer that makes partial
progress plus an honest failure report the worst case:

* :class:`RetryPolicy` — max attempts, deterministic seeded exponential
  backoff + jitter (``backoff(cell_key, attempt)`` hashes the cell key,
  so delays are reproducible across runs and worker counts), a per-cell
  wall-clock timeout, and the transient/permanent failure taxonomy
  (:meth:`RetryPolicy.retryable`).
* :func:`execute_cell` — one cell through the policy: retry transient
  failures with backoff, validate the returned record
  (:func:`validate_record`), stamp retried successes with a
  ``resilience`` block, and quarantine a cell that exhausts its attempts
  as a schema-versioned ``status: "failed"`` record
  (:func:`quarantine_record`) that flows through the normal store path.
  This is the single-worker execution primitive; the pool runner applies
  the same accounting future-by-future.
* :func:`run_resilient_pool` — the process-pool loop: deadline-tracked
  futures, ``BrokenProcessPool`` detection with automatic pool rebuild
  and resubmission of the lost in-flight cells, per-cell timeouts
  enforced by killing the (unkillable-from-the-API) running worker and
  rebuilding, and a cooperative stop flag for signal-driven shutdown.
* :func:`interrupt_scope` — SIGINT/SIGTERM set a stop flag (second
  signal raises ``KeyboardInterrupt``); the campaign drains, flushes
  the store and telemetry sidecars, and returns a partial report.

Quarantine semantics: a failed record carries the exception type, a
traceback tail, the attempt count, and per-attempt durations; it resumes
as "done" (same search config) so a restarted campaign does not bang its
head on a permanent failure — ``retry_failed=True`` (CLI
``--retry-failed``) opts quarantined cells back in. Failed records are
never silently mixed into frontiers, reports, or placement: every
consumer checks :func:`repro.dse.store.record_status`.

Obs counters: ``cells.retried`` (one per retry), ``cells.failed`` (one
per quarantine), ``pool.rebuilds`` (one per pool replacement) — the
report's "Failures & retries" table reads them back.

Everything here is deterministic-testable without flaky sleeps via the
fault-injection harness in :mod:`repro.testing.faults`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import heapq
import itertools
import signal
import threading
import time
import traceback
from concurrent.futures import FIRST_COMPLETED, wait
from concurrent.futures.process import BrokenProcessPool
from typing import Callable, Mapping, Sequence

from repro_torch.obs import NULL

from .store import SCHEMA_VERSION, record_status

#: Version of the quarantine-record layout (the ``quarantine_schema``
#: field on ``status: "failed"`` records).
QUARANTINE_SCHEMA_VERSION = 1

#: Exception classes retrying cannot fix: the models are deterministic,
#: so a bad-input/bad-config error reproduces identically on attempt 2.
PERMANENT_ERRORS = (ValueError, KeyError, TypeError, IndexError,
                    AttributeError, ZeroDivisionError, AssertionError)

#: Characters of formatted traceback kept on a quarantine record — the
#: tail is where the raising frame and message live.
TRACEBACK_TAIL_CHARS = 2000


class CellTimeout(Exception):
    """A cell exceeded the policy's per-attempt wall-clock deadline
    (always retryable: stragglers are load, not logic)."""


class WorkerCrash(Exception):
    """A pool worker died mid-cell (``BrokenProcessPool``: SIGKILL, OOM,
    ``os._exit``). The executor API cannot name the culprit cell, so
    every in-flight cell is charged one crash attempt and resubmitted —
    with ``max_attempts >= 2`` no cell is lost to a single crash."""


class CorruptRecord(RuntimeError):
    """A worker returned something that is not a plausible record for
    the submitted cell (retryable — transport/serialization damage)."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How hard a campaign fights for each cell.

    ``backoff(cell_key, attempt)`` is exponential
    (``backoff_s * backoff_factor**(attempt-1)``) with a deterministic
    jitter in ``±jitter_frac`` derived from
    ``sha256(seed|cell_key|attempt)`` — reproducible, yet de-synchronized
    across cells so retry herds do not stampede together.

    ``cell_timeout_s`` is the per-attempt wall-clock deadline, enforced
    on the pool path by killing the worker processes and rebuilding the
    pool (``concurrent.futures`` cannot cancel running work); the
    single-worker path runs attempts inline and cannot preempt them, so
    the timeout applies to pool campaigns only.
    """

    max_attempts: int = 3
    backoff_s: float = 0.05
    backoff_factor: float = 2.0
    jitter_frac: float = 0.1
    cell_timeout_s: float | None = None
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, "
                             f"got {self.max_attempts}")
        if self.cell_timeout_s is not None and self.cell_timeout_s <= 0:
            raise ValueError(f"cell_timeout_s must be positive or None, "
                             f"got {self.cell_timeout_s}")

    def backoff(self, cell_key: str, attempt: int) -> float:
        """Seconds to wait before re-running ``cell_key`` after failed
        attempt number ``attempt`` (1-based). Deterministic."""
        base = self.backoff_s * self.backoff_factor ** (attempt - 1)
        digest = hashlib.sha256(
            f"{self.seed}|{cell_key}|{attempt}".encode()).digest()
        unit = int.from_bytes(digest[:8], "big") / 2 ** 64   # [0, 1)
        return base * (1.0 + self.jitter_frac * (2.0 * unit - 1.0))

    def retryable(self, exc: BaseException) -> bool:
        """The failure taxonomy: timeouts, crashes, corrupt returns, and
        generic runtime errors are transient (retry); the deterministic
        model-error classes (:data:`PERMANENT_ERRORS`) are permanent —
        the same inputs will fail the same way."""
        if isinstance(exc, (CellTimeout, WorkerCrash, CorruptRecord,
                            BrokenProcessPool)):
            return True
        return not isinstance(exc, PERMANENT_ERRORS)


def attempt_outcome(exc: BaseException) -> str:
    """Attempt-log label for a failure: ``timeout`` / ``crash`` /
    ``corrupt`` / ``error``."""
    if isinstance(exc, CellTimeout):
        return "timeout"
    if isinstance(exc, (WorkerCrash, BrokenProcessPool)):
        return "crash"
    if isinstance(exc, CorruptRecord):
        return "corrupt"
    return "error"


def validate_record(cell, rec) -> None:
    """Raise :class:`CorruptRecord` unless ``rec`` is a plausible store
    record for ``cell`` — the parent-side guard between a worker's
    return value and ``store.put`` (a crashed serializer or an injected
    ``corrupt-record`` fault fails here and is retried)."""
    if not isinstance(rec, dict):
        raise CorruptRecord(f"cell {cell.key}: worker returned "
                            f"{type(rec).__name__}, not a record dict")
    if rec.get("cell_key") != cell.key:
        raise CorruptRecord(f"cell {cell.key}: worker returned a record "
                            f"for {rec.get('cell_key')!r}")
    if not isinstance(rec.get("objectives"), Mapping):
        raise CorruptRecord(f"cell {cell.key}: record has no objectives "
                            f"dict (corrupt worker return)")


def _tb_tail(exc: BaseException, limit: int = TRACEBACK_TAIL_CHARS) -> str:
    text = "".join(traceback.format_exception(type(exc), exc,
                                              exc.__traceback__))
    return text[-limit:]


def quarantine_record(cell, *, search: Mapping | None,
                      error: BaseException,
                      attempt_log: Sequence[Mapping],
                      backend: str = "fpga") -> dict:
    """The schema-versioned ``status: "failed"`` store record for a cell
    that exhausted its attempts. Carries enough to diagnose without the
    original logs (exception type, traceback tail, per-attempt outcomes
    and durations) and the search config, so resume treats it as "done
    under these settings" until ``--retry-failed`` or a config change.
    ``evaluations: 0`` keeps campaign accounting uniform. The ``backend``
    field follows the success-record convention (absent for fpga)."""
    rec = {
        "schema": SCHEMA_VERSION,
        "status": "failed",
        "quarantine_schema": QUARANTINE_SCHEMA_VERSION,
        "cell_key": cell.key,
        "cell": dataclasses.asdict(cell),
        "search": dict(search) if search is not None else None,
        "error_type": type(error).__name__,
        "error": _tb_tail(error),
        "attempts": len(attempt_log),
        "attempt_log": [dict(a) for a in attempt_log],
        "evaluations": 0,
    }
    if backend != "fpga":
        rec["backend"] = backend
    return rec


def stamp_resilience(rec: dict, attempt_log: Sequence[Mapping]) -> dict:
    """Attach retry metadata to a success record that needed more than
    one attempt. First-attempt successes are NOT stamped — fault-free
    campaigns stay byte-identical to pre-resilience stores."""
    out = dict(rec)
    out["resilience"] = {
        "attempts": len(attempt_log),
        "retries": sum(1 for a in attempt_log if a["outcome"] != "ok"),
        "attempt_log": [dict(a) for a in attempt_log],
    }
    return out


@dataclasses.dataclass
class CellOutcome:
    """What happened to one cell: a record to store (success or
    quarantine), or nothing (``interrupted`` — the cell stays absent
    from the store and a resumed campaign re-runs it)."""

    cell: object
    record: dict | None
    attempt_log: list[dict]
    error: BaseException | None = None
    interrupted: bool = False

    @property
    def ok(self) -> bool:
        return self.record is not None and record_status(self.record) == "ok"

    @property
    def failed(self) -> bool:
        return (self.record is not None
                and record_status(self.record) != "ok")

    @property
    def retried(self) -> bool:
        return any(a["outcome"] != "ok" for a in self.attempt_log)


def _interruptible_sleep(delay: float, stop: threading.Event | None,
                         sleep: Callable[[float], None]) -> None:
    if stop is None:
        if delay > 0:
            sleep(delay)
        return
    # stop.wait returns early when the flag is set — backoff never
    # delays a requested shutdown
    if delay > 0:
        stop.wait(delay)


def execute_cell(cell, attempt_fn: Callable[[object, int], dict],
                 policy: RetryPolicy | None = None, *,
                 search: Mapping | None = None, backend: str = "fpga",
                 stop: threading.Event | None = None, tracer=NULL,
                 sleep: Callable[[float], None] = time.sleep) -> CellOutcome:
    """Run one cell under the policy, inline (the single-worker path).

    ``attempt_fn(cell, attempt)`` performs attempt number ``attempt``
    (1-based) and returns a store record. Transient failures retry with
    deterministic backoff; permanent failures and exhausted budgets
    quarantine. ``stop`` aborts between attempts (the cell is then
    ``interrupted`` — nothing is stored, resume re-runs it).

    The per-attempt wall-clock timeout is a pool-path feature (workers
    can be killed); inline attempts cannot be preempted, so
    ``policy.cell_timeout_s`` is not enforced here.
    """
    policy = policy or RetryPolicy()
    attempt_log: list[dict] = []
    last_exc: BaseException | None = None
    for attempt in range(1, policy.max_attempts + 1):
        if stop is not None and stop.is_set():
            return CellOutcome(cell, None, attempt_log, error=last_exc,
                               interrupted=True)
        t0 = time.perf_counter()
        try:
            rec = attempt_fn(cell, attempt)
            validate_record(cell, rec)
        except Exception as exc:
            dur = time.perf_counter() - t0
            attempt_log.append({"attempt": attempt,
                                "outcome": attempt_outcome(exc),
                                "duration_s": round(dur, 4),
                                "error_type": type(exc).__name__})
            last_exc = exc
            if not policy.retryable(exc) or attempt == policy.max_attempts:
                break
            tracer.count("cells.retried", cell=cell.key,
                         error=type(exc).__name__)
            _interruptible_sleep(policy.backoff(cell.key, attempt), stop,
                                 sleep)
        else:
            dur = time.perf_counter() - t0
            attempt_log.append({"attempt": attempt, "outcome": "ok",
                                "duration_s": round(dur, 4),
                                "error_type": None})
            if attempt > 1:
                rec = stamp_resilience(rec, attempt_log)
            return CellOutcome(cell, rec, attempt_log)
    tracer.count("cells.failed", cell=cell.key,
                 error=type(last_exc).__name__)
    qrec = quarantine_record(cell, search=search, error=last_exc,
                             attempt_log=attempt_log, backend=backend)
    return CellOutcome(cell, qrec, attempt_log, error=last_exc)


# ---------------------------------------------------------------------------
# the resilient pool loop
# ---------------------------------------------------------------------------

#: Ceiling on one ``wait()`` tick: keeps the loop responsive to the stop
#: flag and to newly-eligible (backed-off) resubmissions.
_TICK_S = 0.2


@dataclasses.dataclass
class PoolStats:
    rebuilds: int = 0
    interrupted: bool = False


def _kill_pool(pool) -> None:
    """Tear a pool down NOW: cancel queued work, terminate workers
    (running cells cannot be cancelled through the API — killing the
    process is the only preemption there is)."""
    procs = list((getattr(pool, "_processes", None) or {}).values())
    pool.shutdown(wait=False, cancel_futures=True)
    for p in procs:  # snapshot first: shutdown may null _processes
        with contextlib.suppress(Exception):
            p.terminate()


def run_resilient_pool(todo: Sequence, *,
                       make_pool: Callable[[], object],
                       submit: Callable[[object, object, int], object],
                       on_outcome: Callable[[CellOutcome], None],
                       policy: RetryPolicy | None = None,
                       search: Mapping | None = None,
                       backend: str = "fpga",
                       stop: threading.Event | None = None,
                       tracer=NULL, workers: int | None = None,
                       clock: Callable[[], float] = time.monotonic,
                       ) -> PoolStats:
    """Fan ``todo`` over a process pool with retries, timeouts, crash
    recovery, and cooperative shutdown.

    ``submit(pool, cell, attempt)`` submits one attempt and returns its
    future; ``on_outcome`` receives each cell's :class:`CellOutcome` in
    completion order (success or quarantine — interrupted cells are not
    reported, they simply stay absent from the store).

    Failure handling, per future:

    * exception -> one failed attempt; transient + budget left -> the
      cell re-enters the submit queue after its deterministic backoff.
    * ``BrokenProcessPool`` -> EVERY in-flight cell is charged one
      ``crash`` attempt (the executor cannot name the culprit), the pool
      is rebuilt (``pool.rebuilds`` counter), and survivors resubmit.
    * deadline exceeded (``policy.cell_timeout_s``) -> the overdue cells
      are charged a ``timeout`` attempt; the pool is killed and rebuilt
      (running work cannot be cancelled), and the innocent in-flight
      cells resubmit WITHOUT being charged an attempt.
    * ``stop`` set -> pending futures are cancelled, workers killed,
      and the loop returns with ``interrupted=True``.
    """
    policy = policy or RetryPolicy()
    stats = PoolStats()
    tie = itertools.count()
    # (eligible-time, tiebreak, cell) — cells waiting to be (re)submitted
    ready: list[tuple[float, int, object]] = [(0.0, next(tie), c)
                                              for c in todo]
    heapq.heapify(ready)
    state = {c.key: {"attempt": 0, "log": [], "t0": 0.0} for c in todo}
    inflight: dict[object, object] = {}       # future -> cell
    deadlines: dict[object, float] = {}       # future -> monotonic deadline
    remaining = len(todo)
    pool = make_pool()

    def fail_attempt(cell, exc: BaseException, dur: float) -> None:
        nonlocal remaining
        st = state[cell.key]
        st["log"].append({"attempt": st["attempt"],
                          "outcome": attempt_outcome(exc),
                          "duration_s": round(dur, 4),
                          "error_type": type(exc).__name__})
        if policy.retryable(exc) and st["attempt"] < policy.max_attempts:
            tracer.count("cells.retried", cell=cell.key,
                         error=type(exc).__name__)
            eligible = clock() + policy.backoff(cell.key, st["attempt"])
            heapq.heappush(ready, (eligible, next(tie), cell))
            return
        tracer.count("cells.failed", cell=cell.key,
                     error=type(exc).__name__)
        qrec = quarantine_record(cell, search=search, error=exc,
                                 attempt_log=st["log"], backend=backend)
        remaining -= 1
        on_outcome(CellOutcome(cell, qrec, st["log"], error=exc))

    def settle(fut, cell, *, now: float) -> bool:
        """Resolve one completed future; True when the pool broke."""
        nonlocal remaining
        st = state[cell.key]
        dur = now - st["t0"]
        exc = fut.exception()
        if isinstance(exc, BrokenProcessPool):
            fail_attempt(cell, WorkerCrash(
                f"worker died while {len(inflight) + 1} cell(s) were "
                f"in flight ({exc})"), dur)
            return True
        if exc is not None:
            fail_attempt(cell, exc, dur)
            return False
        rec = fut.result()
        try:
            validate_record(cell, rec)
        except CorruptRecord as bad:
            fail_attempt(cell, bad, dur)
            return False
        st["log"].append({"attempt": st["attempt"], "outcome": "ok",
                          "duration_s": round(dur, 4), "error_type": None})
        if st["attempt"] > 1:
            rec = stamp_resilience(rec, st["log"])
        remaining -= 1
        on_outcome(CellOutcome(cell, rec, st["log"]))
        return False

    def rebuild() -> None:
        nonlocal pool
        _kill_pool(pool)
        inflight.clear()
        deadlines.clear()
        pool = make_pool()
        stats.rebuilds += 1
        tracer.count("pool.rebuilds")

    try:
        while remaining > 0:
            if stop is not None and stop.is_set():
                stats.interrupted = True
                return stats
            now = clock()
            submitted = False
            while ready and ready[0][0] <= now:
                _, _, cell = heapq.heappop(ready)
                st = state[cell.key]
                st["attempt"] += 1
                st["t0"] = clock()
                fut = submit(pool, cell, st["attempt"])
                inflight[fut] = cell
                submitted = True
                if policy.cell_timeout_s is not None:
                    deadlines[fut] = st["t0"] + policy.cell_timeout_s
            if submitted:
                tracer.gauge("pool.inflight", len(inflight),
                             workers=workers)

            if not inflight:
                # everything is backing off; sleep toward the nearest
                # eligible time (capped for stop responsiveness)
                _interruptible_sleep(
                    min(_TICK_S, max(0.0, ready[0][0] - clock()))
                    if ready else _TICK_S, stop, time.sleep)
                continue

            tick = _TICK_S
            if deadlines:
                tick = min(tick, max(0.0, min(deadlines.values()) - now))
            if ready:
                tick = min(tick, max(0.0, ready[0][0] - now))
            done, _ = wait(list(inflight), timeout=tick,
                           return_when=FIRST_COMPLETED)

            now = clock()
            broken = False
            for fut in done:
                cell = inflight.pop(fut)
                deadlines.pop(fut, None)
                broken = settle(fut, cell, now=now) or broken
            if done:
                tracer.gauge("pool.inflight", len(inflight),
                             workers=workers)
            if broken:
                # the pool is dead: every still-inflight future is (or is
                # about to be) BrokenProcessPool — drain them all as
                # crashes, then rebuild once
                settled, _ = wait(list(inflight), timeout=5.0)
                for fut in settled:
                    cell = inflight.pop(fut)
                    deadlines.pop(fut, None)
                    settle(fut, cell, now=now)
                for fut, cell in list(inflight.items()):
                    st = state[cell.key]
                    fail_attempt(cell, WorkerCrash(
                        "worker died; future never settled"),
                        now - st["t0"])
                rebuild()
                continue

            overdue = [f for f, dl in deadlines.items() if dl <= now]
            if overdue:
                # kill-and-rebuild is the only preemption; the innocent
                # in-flight cells are requeued without an attempt charge
                for fut, cell in list(inflight.items()):
                    st = state[cell.key]
                    if fut in overdue:
                        fail_attempt(cell, CellTimeout(
                            f"cell exceeded --cell-timeout "
                            f"{policy.cell_timeout_s}s "
                            f"(attempt {st['attempt']})"), now - st["t0"])
                    else:
                        st["attempt"] -= 1
                        heapq.heappush(ready, (now, next(tie), cell))
                rebuild()
    finally:
        if stats.interrupted or remaining > 0:
            _kill_pool(pool)
        else:
            pool.shutdown(wait=True)
    return stats


# ---------------------------------------------------------------------------
# signal handling
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def interrupt_scope(install: bool = True):
    """Yield a ``threading.Event`` that SIGINT/SIGTERM set.

    The first signal requests a graceful stop (drain in-flight work,
    flush the store, return a partial report); a second SIGINT raises
    ``KeyboardInterrupt`` — the user insists. Previous handlers are
    restored on exit. Outside the main thread (or with
    ``install=False``) no handlers are touched and the event is simply
    never signal-set."""
    stop = threading.Event()
    if not install or threading.current_thread() is not \
            threading.main_thread():
        yield stop
        return
    previous = {}

    def _handler(signum, frame):
        if stop.is_set() and signum == signal.SIGINT:
            raise KeyboardInterrupt
        stop.set()

    for sig in (signal.SIGINT, signal.SIGTERM):
        with contextlib.suppress(ValueError, OSError):
            previous[sig] = signal.signal(sig, _handler)
    try:
        yield stop
    finally:
        for sig, handler in previous.items():
            with contextlib.suppress(ValueError, OSError):
                signal.signal(sig, handler)
