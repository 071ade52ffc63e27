"""Audio I/O of the port."""
