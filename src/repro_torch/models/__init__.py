"""Model definitions of the port: the dense decoder."""
