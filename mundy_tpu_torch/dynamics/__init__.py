"""Dynamics: counter-based Brownian noise and explicit integration."""
