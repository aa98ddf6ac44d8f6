"""Training: the single-device and sharded step (`step.py`) and
checkpoints (`checkpoint.py`)."""
