"""Stdlib helpers."""
