"""Host I/O of the port: DADA files, the shared-memory ring buffer, the UDP
capture engine and the frame sender."""
