"""Drivers: configuration -> assembled simulation -> time loop."""
