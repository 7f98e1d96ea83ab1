"""Pairwise Chebyshev matrices for the materialized estimators.

``ops.py`` is the public entry, ``ref.py`` the plain PyTorch version,
``kernel.py`` the ctypes binding of ``csrc/pairwise_cheb.cu``.
"""
