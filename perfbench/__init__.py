"""The benchmark of seganygaussians_torch on one NVIDIA H100 (see run.py)."""
