"""First-order engines: restarted PDHG (``pdhg.py``)."""
