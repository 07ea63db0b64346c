"""Plain references, in PyTorch, that import nothing of the port.

Each works out again, from the inputs the benchmark made, whatever the
program derived from them, and judges the program's answers.
"""
