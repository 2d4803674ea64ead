"""Part of the benchmark (portbench/apps)."""
