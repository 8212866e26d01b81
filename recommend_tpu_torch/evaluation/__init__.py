"""Offline evaluation: the ranking evaluator, latency percentiles and MFU."""
