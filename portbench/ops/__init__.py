"""The callers of the entry points, one per traffic mix's ``op``."""
