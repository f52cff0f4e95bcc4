"""The plain reference: the window semantics replayed in plain PyTorch,
with the exact k nearest live ids.  Imports nothing of the program."""
