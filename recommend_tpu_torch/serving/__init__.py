"""Ranking inference engine and incremental parameter push."""
