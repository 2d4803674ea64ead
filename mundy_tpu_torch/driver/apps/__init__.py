"""Apps: one assembled simulation per configuration."""
