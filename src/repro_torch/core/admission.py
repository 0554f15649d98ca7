"""Deadline-aware admission control for the continuous-batching serve path
(copy of ``repro.core.admission``, pure Python).

HeterPS's scheduler minimizes cost *subject to throughput constraints* —
but a serve loop that admits FIFO until the page pool blocks has no
constraint at all under overload: a traffic burst collapses TTFT for
every request instead of protecting goodput.  This module is the
admission half of that constraint:

* a four-way **outcome taxonomy** every request terminates in —
  :data:`COMPLETED` / :data:`REJECTED` / :data:`TIMED_OUT` /
  :data:`PREEMPTED` — so nothing can hang silently;
* :class:`AdmissionPolicy` — a bounded admission queue plus a
  measured-rate deadline feasibility test: using EMA estimates of
  prefill seconds and per-output-token decode seconds (TPOT), a request
  is rejected at arrival when even the *optimistic* service estimate
  (current backlog drained at the measured best rate) cannot meet its
  TTFT or total deadline.  The knobs an external controller tunes
  (``max_concurrency``, ``queue_bound``) live here; the reference's
  ``core/replan.AdmissionActuator`` closes them against measured SLO
  windows (its port waits for the scheduler slice).

The admission math (documented in DESIGN.md "Overload robustness"):
with measured TPOT ``τ`` seconds/token and effective decode concurrency
``c``, the batch drains ``c/τ`` tokens per second, so a request behind a
backlog of ``B`` scheduled tokens waits an estimated ``B·τ/c`` seconds
before its prefill (EMA ``ρ`` seconds) can produce the first token:

    TTFT_est  = (now − arrival) + B·τ/c + ρ
    total_est = TTFT_est + gen·τ

Both estimates are *optimistic* (they assume the measured steady-state
rate with no further arrivals), so a rejection is a proof sketch: the
deadline cannot be met even under best-case service.  Unmeasured rates
(``τ == 0``, a cold loop) admit everything — there is no basis to
reject yet.
"""

from __future__ import annotations

#: terminal request outcomes — every request the serve loop sees ends in
#: exactly one of these (the "zero hung requests" contract)
COMPLETED = "completed"    #: finished its full generation
REJECTED = "rejected"      #: never admitted (oversize / queue / deadline)
TIMED_OUT = "timed_out"    #: deadline passed while queued or mid-decode
PREEMPTED = "preempted"    #: evicted mid-flight and never resumed

OUTCOMES = (COMPLETED, REJECTED, TIMED_OUT, PREEMPTED)


class AdmissionPolicy:
    """Bounded admission queue + measured-rate deadline feasibility.

    The serve loop consults :meth:`admit_check` when a request *arrives*
    (joins the admission queue) and feeds measurements back through
    :meth:`observe_prefill` / :meth:`observe_tpot` as requests prefill
    and complete.  ``max_concurrency`` caps live decode slots and
    ``queue_bound`` caps the admission queue depth (``None`` =
    unbounded); both are plain attributes so a controller thread (the
    AIMD actuator) can retune them while the loop runs — single
    attribute reads/writes, safe under the GIL.
    """

    def __init__(self, *, slots: int, queue_bound: int | None = None,
                 max_concurrency: int | None = None,
                 prefill_s: float = 0.0, tpot_s: float = 0.0,
                 ema: float = 0.3):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.slots = int(slots)
        self.max_concurrency = (int(max_concurrency)
                                if max_concurrency is not None else slots)
        self.queue_bound = (int(queue_bound) if queue_bound is not None
                            else None)
        #: EMA measured rates; 0.0 = not yet measured (admit everything)
        self.prefill_s = float(prefill_s)
        self.tpot_s = float(tpot_s)
        self.ema = float(ema)
        self.admitted = 0
        self.rejections: dict[str, int] = {}

    # -- measurement feedback ---------------------------------------------

    def _ema(self, old: float, new: float) -> float:
        return new if old <= 0.0 else (1 - self.ema) * old + self.ema * new

    def observe_prefill(self, seconds: float) -> None:
        if seconds > 0:
            self.prefill_s = self._ema(self.prefill_s, float(seconds))

    def observe_tpot(self, seconds: float) -> None:
        if seconds > 0:
            self.tpot_s = self._ema(self.tpot_s, float(seconds))

    # -- estimates --------------------------------------------------------

    @property
    def concurrency(self) -> int:
        """Effective decode concurrency the estimate assumes."""
        return max(1, min(self.slots, int(self.max_concurrency)))

    def estimate_ttft(self, *, now: float, arrival: float,
                      backlog_tokens: float) -> float:
        """Optimistic arrival→first-token estimate behind ``backlog``
        scheduled tokens (0.0 when rates are unmeasured)."""
        if self.tpot_s <= 0.0:
            return 0.0
        wait = backlog_tokens * self.tpot_s / self.concurrency
        return (now - arrival) + wait + self.prefill_s

    # -- the admission decision -------------------------------------------

    def admit_check(self, *, now: float, arrival: float, gen: int,
                    ttft_deadline: float | None = None,
                    total_deadline: float | None = None,
                    backlog_tokens: float = 0.0,
                    queue_len: int = 0) -> str | None:
        """``None`` to admit, else a typed reject reason.

        ``backlog_tokens`` is the sum of scheduled output tokens ahead of
        this request (in-flight remainders + queued generations);
        ``queue_len`` the current admission-queue depth.  Deadlines are
        absolute offsets from ``arrival``.
        """
        if self.queue_bound is not None and queue_len >= self.queue_bound:
            return self._reject("queue_full")
        if self.tpot_s > 0.0:
            ttft_est = self.estimate_ttft(now=now, arrival=arrival,
                                          backlog_tokens=backlog_tokens)
            if ttft_deadline is not None and ttft_est > ttft_deadline:
                return self._reject("ttft_deadline")
            if (total_deadline is not None
                    and ttft_est + gen * self.tpot_s > total_deadline):
                return self._reject("total_deadline")
        self.admitted += 1
        return None

    def _reject(self, reason: str) -> str:
        self.rejections[reason] = self.rejections.get(reason, 0) + 1
        return reason

    def report(self) -> dict:
        return {
            "max_concurrency": self.max_concurrency,
            "queue_bound": self.queue_bound,
            "prefill_s": self.prefill_s,
            "tpot_s": self.tpot_s,
            "admitted": self.admitted,
            "rejections": dict(self.rejections),
        }
