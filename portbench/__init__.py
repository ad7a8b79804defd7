"""The benchmark of ``relp_tpu_torch`` on an NVIDIA H100 (see README.md).

Everything here is the yardstick: LP generators, request kinds, the plain
reference and the certificate that decides ``correct``, the device-trace
reader, the roofline byte counts and one reader per metric.  It imports
nothing of the JAX package.
"""
