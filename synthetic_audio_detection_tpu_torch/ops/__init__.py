"""Log-mel front end, smoothing filter, and the CUDA kernels with their build."""
