"""Entry points of the port: the LM serving loop."""
