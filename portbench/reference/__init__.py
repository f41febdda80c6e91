"""Plain PyTorch references; nothing of the program is imported here."""
