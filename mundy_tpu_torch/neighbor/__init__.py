"""Neighbor search: the dense row-grid engine."""
