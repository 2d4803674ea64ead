"""Geometry: periodic-box metrics."""
