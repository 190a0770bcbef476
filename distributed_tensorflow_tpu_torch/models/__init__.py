"""Models of the port (so far the GPT decoder's serving subset)."""
