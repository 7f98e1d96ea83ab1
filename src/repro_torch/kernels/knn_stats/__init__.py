"""Fused kNN statistics for the KSG-family estimators.

``ops.py`` is the public entry, ``ref.py`` the plain PyTorch version,
``kernel.py`` the ctypes binding of ``csrc/radius_counts.cu``.
"""
