"""Scheduler: the sequences each decode step of the window decoded (what
``ServeEngine.step`` returns), on average: the batch the engine keeps
running against its ``max_batch``."""


def read(run):
    sizes = [n for t, n in run.steps if run.in_window(t)]
    return sum(sizes) / len(sizes) if sizes else None
