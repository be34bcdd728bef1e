"""Block-I/O request model mirroring the Linux bio interface BTT exposes.

The paper's device speaks standard ``bio`` with flags; Caiti must support all
of them (Section 4.4).  We reproduce the subset that carries semantics for the
caching layer: REQ_PREFLUSH (flush the volatile device cache before the
request), REQ_FUA (force unit access — ack only after durable commit) and
SYNC (the submitter synchronously waits).  An ``fsync`` is translated, exactly
as in the kernel, to an empty bio with PREFLUSH|FUA set.
"""
from __future__ import annotations

import enum
import itertools
import threading
from dataclasses import dataclass, field


class BioFlags(enum.IntFlag):
    NONE = 0
    REQ_PREFLUSH = 1 << 0   # flush device cache before servicing this bio
    REQ_FUA = 1 << 1        # ack only once data is durable in the backend
    SYNC = 1 << 2           # submitter waits synchronously


class BioOp(enum.Enum):
    READ = "read"
    WRITE = "write"
    FLUSH = "flush"         # empty bio carrying PREFLUSH (ext4 journal tick)


#: Result codes, matching the paper's SUCCESS / -EIO convention.
SUCCESS = 0
EIO = -5

_bio_ids = itertools.count()


@dataclass
class Bio:
    """One block I/O request (one ``lba``, one block of data)."""

    op: BioOp
    lba: int = -1
    data: bytes | memoryview | None = None
    flags: BioFlags = BioFlags.NONE
    bio_id: int = field(default_factory=lambda: next(_bio_ids))
    # Completion signalling (device sets result then fires the event).
    result: int | None = None
    _done: threading.Event = field(default_factory=threading.Event, repr=False)

    def complete(self, result: int) -> None:
        self.result = result
        self._done.set()

    def wait(self, timeout: float | None = None) -> int:
        if not self._done.wait(timeout):
            raise TimeoutError(f"bio {self.bio_id} did not complete")
        assert self.result is not None
        return self.result


def fsync_bio() -> Bio:
    """An fsync as the kernel would emit it: empty PREFLUSH|FUA bio."""
    return Bio(op=BioOp.FLUSH, flags=BioFlags.REQ_PREFLUSH | BioFlags.REQ_FUA | BioFlags.SYNC)


def preflush_bio() -> Bio:
    """The ext4 5-second journal-commit flush: PREFLUSH, *not* SYNC."""
    return Bio(op=BioOp.FLUSH, flags=BioFlags.REQ_PREFLUSH)
