"""Presolve rules and postsolve reconstruction (host code)."""
