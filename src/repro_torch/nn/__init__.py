"""NN building blocks of the port (norms, rope, attention, FFN)."""
