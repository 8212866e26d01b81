"""Ranking training: loss, dense optimizer, metrics, checkpoints and the trainer."""
