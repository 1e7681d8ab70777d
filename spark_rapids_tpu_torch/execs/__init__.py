"""Device operators (execs) of the port."""
