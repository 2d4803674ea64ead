"""The benchmark of mundy_tpu_torch on one NVIDIA GPU: see run.py."""
