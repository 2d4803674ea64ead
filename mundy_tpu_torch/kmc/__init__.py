"""Kinetic Monte Carlo crosslinker binding and unbinding."""
