"""Host I/O of the port: DADA files and the shared-memory ring buffer."""
