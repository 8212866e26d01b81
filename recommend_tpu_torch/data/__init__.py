"""Seeded synthetic ranking data and its batch iterator (numpy)."""
