"""The plain reference the benchmark compares the program with. It
imports nothing of the program."""
