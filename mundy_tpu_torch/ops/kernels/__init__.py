"""CUDA kernels for the hot compute paths (the port of ops/pallas/)."""
