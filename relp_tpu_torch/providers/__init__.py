"""Column-oracle layer: so far the per-variable feasibility logic (variable.py)."""
