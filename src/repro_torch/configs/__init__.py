"""The paper's own CloudSort configuration (cloudsort.py)."""
