"""Sparse formats of the port: COO/CSR containers and the mono BSR, ELL and
hybrid layouts."""
