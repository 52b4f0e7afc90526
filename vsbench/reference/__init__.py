"""The plain reference: what the system owes its callers, computed
directly in PyTorch and NumPy. Imports nothing of the program under test."""
