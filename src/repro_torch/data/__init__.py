"""Synthetic corpora (numpy)."""
