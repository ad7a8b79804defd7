"""LP families, one module each, found by the ``family`` of a configuration
file.  A family module defines ``make(config, seed, k) -> LP``."""
