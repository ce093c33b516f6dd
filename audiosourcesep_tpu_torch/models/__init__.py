"""Models of the port (NCSN so far)."""
