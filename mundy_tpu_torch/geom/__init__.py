"""Geometry: periodic-box metrics, primitives, distances, bounding boxes,
rigid transforms and random configurations."""
