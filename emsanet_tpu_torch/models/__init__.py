"""Model modules of the port (NCHW inside, NHWC at the boundary)."""
