"""Training entry points of the port (the LBPH trainer)."""
