"""The plain reference (nerfies.py)."""
