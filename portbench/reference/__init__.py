"""The plain reference that decides ``correct``: float64 PyTorch and numpy,
importing nothing of the program (``blf_tpu_torch``), of ``blf_tpu`` or of
JAX."""
