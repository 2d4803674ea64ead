"""Core utilities: frozen dataclass containers, assertions, config."""
