"""From the end of a session's tool pause to its next output token, p90
over every pause that ends in the window (to the close, where no token
came), in ms."""
import numpy as np


def read(run):
    v = run.resume_latencies()
    return float(np.percentile(v, 90)) * 1e3 if v else None
