"""Output tokens produced in the window over the window's seconds."""


def read(run):
    return run.tokens_in_window() / run.seconds
