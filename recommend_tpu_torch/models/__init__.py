"""Ranking model, unified tokenizer and the DCNv2+DIN baseline."""
