"""Host-side data streams of the port."""
