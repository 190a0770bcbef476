"""Train steps of the port (one device so far)."""
