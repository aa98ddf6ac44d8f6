"""Training: the single-device and sharded step (`step.py`), checkpoints
(`checkpoint.py`), the process-group backend over a train worker group
(`backend.py`) and the state broadcast to joining ranks (`session.py`)."""
