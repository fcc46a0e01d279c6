"""Pipeline stages of the port (the network frontend so far)."""
