"""Ranking model and unified tokenizer."""
