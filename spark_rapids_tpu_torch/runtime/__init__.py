"""Runtime services of the port (speculative sizing)."""
