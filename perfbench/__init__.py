"""The port's serving benchmark: one cell (a model configuration under a
traffic mix) run once per call of ``run_cell.py``."""
