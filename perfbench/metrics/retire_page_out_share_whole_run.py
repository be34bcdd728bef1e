"""KV cache transit: the pages ``ServeEngine._retire`` paged out itself
(the program's ``retire_pages_out``), which ``release`` then drops unread,
over every page paged out (``pages_out``), in %.

Over the engine's whole life, not the window: warm-up, ramp, window and
the slice's grace.  The program's live counters reach a reader only
through the traced run's ``Recorder``, and the harness takes only its own
list of counters at the window's edges.  So the share depends on the
run's length (the ramp holds suspends of sessions that retire later): it
compares two runs of one ``--seconds`` only.  The share in the window
waits for the harness to take the counter at the window's edges.  None
from a program without the counter."""


def read(run):
    count = run.rec.count if run.rec is not None else {}
    if "retire_pages_out" not in count or not count.get("pages_out"):
        return None
    return 100.0 * count["retire_pages_out"] / count["pages_out"]
