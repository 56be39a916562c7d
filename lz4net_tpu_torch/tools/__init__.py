"""Measurement tools of the CUDA port, run by hand on the card."""
