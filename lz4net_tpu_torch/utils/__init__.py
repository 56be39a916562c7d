"""Corpus helpers of the CUDA port."""
