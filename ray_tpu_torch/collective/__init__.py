"""Collectives over the runtime seam: `broadcast_pytree`, the packed
weight broadcast of the RLHF actor topology (`collective.py`)."""
