"""Group spans: where one engine group's time went, on the host clock.

The engine keeps one :class:`GroupSpans` per group it serves (a batch of
the queue, a ``transcribe_sync`` call, a prewarm shape, a window of a long
final's seek loop) and hands the same record to every output of the group
(``DecodeOutput.spans``). Every stamp is ``time.perf_counter()``, the clock
a ``torch.profiler`` trace can be pinned to, so the intervals can be laid
beside the device operations of a traced stretch.

- Per request: ``submitted``, when each row's request was made.
- The engine thread, as named intervals that follow one another without a
  gap or an overlap (each ends where the next begins, one clock read each):
  ``sem_wait`` (a group of the queue waiting for a place among the groups
  in flight, from before the wait to the prep's start), ``prep``
  (host packing, the audio wire, prompts), ``lock_wait`` (the device lock),
  ``h2d`` (the copies to the device), ``encode`` (log-mel and encoder
  launches), ``detect`` (cross K/V and language detection), ``prefill``,
  then for each chunk of decode steps ``replay`` (the chunk's launch: a
  captured graph's replay on the card) and ``sync`` (the host's read of the
  finish flag, which waits out the chunk's device work; a drafted decode
  reads it before each chunk), and ``pack``, which ends when the device
  lock is released.
- ``end``: the end of the group's harvest (read back, detokenising, the
  fallback ladder, the word pass, the draft store).

``inference_sec`` is ``end`` less the start of ``prep``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

Interval = Tuple[str, float, float]


@dataclass(eq=False)
class GroupSpans:
    """One group's stamps (module docstring). Filled by the engine as the
    group runs, from its creation, which begins ``prep``; read once its
    outputs are handed out."""

    group_id: int
    submitted: Tuple[float, ...]      # each row's request, in row order
    dispatch: List[Interval] = field(default_factory=list)
    end: Optional[float] = None
    _at: float = field(default_factory=time.perf_counter)  # the next interval's start

    def mark(self, name: str) -> None:
        """End the engine thread's current interval now, as ``name``."""
        now = time.perf_counter()
        self.dispatch.append((name, self._at, now))
        self._at = now

    def queued(self, waited: float) -> None:
        """The group came through the queue: its ``sem_wait`` ran from
        ``waited`` to the prep's start."""
        self.dispatch.insert(0, ("sem_wait", waited, self.t_start))

    def close(self) -> None:
        """The harvest ends now."""
        self.end = time.perf_counter()

    @property
    def t_start(self) -> float:
        """The start of ``prep``: where ``inference_sec`` begins."""
        return next(s for name, s, _ in self.dispatch if name == "prep")

    @property
    def inference_sec(self) -> float:
        return self.end - self.t_start

    @property
    def decode_sec(self) -> float:
        """Seconds of the group's decode on the engine thread, from the
        prefill's end to the last finish-flag read: the chunks' launches and
        the reads, which wait out the chunks' device work."""
        return sum(e - s for name, s, e in self.dispatch if name in ("replay", "sync"))

    def queue_sec(self, row: int) -> float:
        """Row ``row``'s request from its submission to ``t_start``."""
        return self.t_start - self.submitted[row]


class _Discard(GroupSpans):
    def mark(self, name: str) -> None:
        pass


# the sink of a decode that keeps no record (one called on its own)
NO_SPANS: GroupSpans = _Discard(-1, ())

__all__ = ["GroupSpans", "Interval", "NO_SPANS"]
