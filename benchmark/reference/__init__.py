"""The plain reference: the configurations' equations in plain PyTorch and
numpy, independent of the program under test (it imports nothing of it)."""
