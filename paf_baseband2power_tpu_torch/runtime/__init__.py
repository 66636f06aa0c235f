"""Runtime: the streaming executor of the port."""
