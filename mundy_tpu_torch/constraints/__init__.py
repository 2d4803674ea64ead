"""Constraint assembly and resolution."""
