"""The benchmark's frozen yardstick: traffic generation, weights, timing
and profiling, work counts, the plain reference and the comparison that
decides ``correct``.  It imports nothing of the program but the serving
entry it measures (``repro_torch.serve``), and only inside ``serve.py``."""
