"""Ranking inference engine."""
