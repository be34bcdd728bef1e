"""From the process's start to the window's opening: imports, the kernels'
libraries, the weights, the pool, the warm-up and the traffic's ramp."""


def read(run):
    return run.setup_s
