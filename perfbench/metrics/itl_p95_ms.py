"""Gap between consecutive output tokens, p95 over every gap that ends in
the window (tool pauses left out; a running request's open gap counts up
to the close), in ms."""
import numpy as np


def read(run):
    v = run.token_gaps()
    return float(np.percentile(v, 95)) * 1e3 if v else None
