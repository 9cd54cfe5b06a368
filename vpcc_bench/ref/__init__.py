"""The plain reference the benchmark holds the program to: PyTorch,
importing nothing of the program."""
