"""Flash attention (GQA forward, causal or not) for the model stack.

``ops.py`` is the public entry, ``ref.py`` the plain PyTorch versions,
``kernel.py`` the ctypes bindings of ``csrc/flash_wgmma.cu`` (the Hopper
kernel, bfloat16/float16) and ``csrc/flash_attention.cu`` (CUDA cores).
"""
