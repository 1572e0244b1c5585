"""Plain PyTorch references that the benchmark holds the program against.
They import nothing of the program."""
