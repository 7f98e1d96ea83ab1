"""Flash attention (GQA forward, causal or not) for the model stack.

``ops.py`` is the public entry, ``ref.py`` the plain PyTorch versions,
``kernel.py`` the ctypes binding of ``csrc/flash_attention.cu``.
"""
