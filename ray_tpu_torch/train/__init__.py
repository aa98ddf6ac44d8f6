"""Training: the single-device step (`step.py`)."""
