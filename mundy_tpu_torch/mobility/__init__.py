"""Mobility operators."""
