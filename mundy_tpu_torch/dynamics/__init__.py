"""Dynamics: counter-based Brownian noise."""
