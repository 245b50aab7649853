"""Device operators of the port: torch ops and the Hopper kernels."""
