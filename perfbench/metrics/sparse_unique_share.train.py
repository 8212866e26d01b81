"""The unique rows the sparse update touches as a share of its lookups, in
percent: the program's ``sparse_unique_rows`` over ``sparse_lookups``
counters, summed over the tables and the span phase's recorded steps
(``yardstick/spans.py``)."""

from perfbench.yardstick.spans import reading


def read(ctx):
    rows, lookups = (reading(ctx, "sums", n) for n in ("sparse_unique_rows", "sparse_lookups"))
    return 100.0 * rows / lookups if rows is not None and lookups else None
