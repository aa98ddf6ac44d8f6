"""Library utilities: application metrics (`metrics.py`) and the OTLP
export of traces (`tracing.py`)."""
