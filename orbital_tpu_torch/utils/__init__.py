"""Configuration, building and loading of the CUDA kernels, and the f64
oracle binding."""
