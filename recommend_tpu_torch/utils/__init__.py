"""Metric logging and the step profiler."""
