"""The plain reference: an LP operator over the benchmark's own arrays, an
interior-point solve in plain PyTorch (``ipm.py``) and the certificate that
judges an answer (``certificate.py``).  Nothing here imports the program."""
