"""Part of the benchmark (portbench/metrics)."""
