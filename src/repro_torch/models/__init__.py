"""Model families of the port: the dense decoder-only transformer."""
