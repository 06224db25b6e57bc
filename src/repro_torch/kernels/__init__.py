"""The padded-carry executor, its CUDA kernels and their plain versions."""
