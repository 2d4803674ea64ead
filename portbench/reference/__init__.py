"""Part of the benchmark (portbench/reference)."""
