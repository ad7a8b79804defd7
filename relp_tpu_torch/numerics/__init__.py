"""Numerics: the host-side exact verifier and optimality certificate
(``fractions.Fraction``), as in the JAX package."""

from relp_tpu_torch.numerics.exact import ExactVerifier, verify_against_file

__all__ = ["ExactVerifier", "verify_against_file"]
