"""The yardstick: what the benchmark computes itself, independent of the
program under test (inputs, weights, operation counts, peaks, the reduction
of traces to metrics, and the comparison that decides ``correct``)."""
