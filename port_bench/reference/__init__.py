"""The plain float64 reference: nothing of the program."""
