"""Shared infrastructure: metrics."""
