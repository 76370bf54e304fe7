"""Plain references: numpy and plain PyTorch, nothing of the program."""
