"""The decode path of the CUDA port: four kernels and their plain versions."""
