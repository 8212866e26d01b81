"""Ranking training: loss, dense optimizer, streaming AUC and the trainer."""
