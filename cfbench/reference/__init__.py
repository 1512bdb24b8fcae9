"""Plain PyTorch / NumPy reference of the benchmark: imports nothing of the program."""
