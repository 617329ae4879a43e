"""Device-side compute: torch ops plus the hand-written CUDA kernels."""
