"""Pair force laws."""
