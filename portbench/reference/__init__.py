"""The plain reference and its reading of the inputs (float32, no import of
the measured package)."""
