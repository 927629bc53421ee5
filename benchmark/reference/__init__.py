"""The plain reference: exact search in PyTorch, importing nothing of
the program (`exact.py`)."""
