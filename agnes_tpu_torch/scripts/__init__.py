"""scripts of the PyTorch port, run as modules (see the package docstring)."""
