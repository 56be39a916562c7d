"""Decode engines of the CUDA port: the host oracle and the CUDA engine."""
