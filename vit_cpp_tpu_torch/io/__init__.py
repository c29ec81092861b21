"""Host-side I/O of the port (image decode)."""
