"""Models of the port (Llama inference core)."""
