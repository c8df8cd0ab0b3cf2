"""Decode engines beside the greedy loops: batched beam search (beam.py)."""
