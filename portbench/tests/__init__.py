"""Part of the benchmark (portbench/tests)."""
