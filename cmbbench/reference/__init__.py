"""Plain references of the cells' outputs: float64 PyTorch and numpy,
written from the definitions. Nothing here imports the program."""
