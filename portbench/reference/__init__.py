"""The plain float32 reference: imports nothing of the program."""
