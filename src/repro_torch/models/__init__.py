"""Model definitions of the port: the dense decoder and the paper's maxout networks."""
