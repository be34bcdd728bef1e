"""KV cache transit: synchronised seconds of the window's page-ins
(``PagedKVCache.activate``) over the pages they moved, in us a page."""


def read(run):
    if run.rec is None:
        return None
    calls = [(n, t1 - t0) for n, t0, t1 in run.rec.page_in
             if run.in_window(t0)]
    pages = sum(n for n, _ in calls)
    return 1e6 * sum(dt for _, dt in calls) / pages if pages else None
