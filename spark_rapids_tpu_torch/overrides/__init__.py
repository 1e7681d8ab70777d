"""Plan -> device exec conversion of the port."""
