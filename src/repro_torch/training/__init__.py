"""Training utilities: the verified flat-npz checkpoints behind the
engine's exact resume (`checkpoint.py`)."""
