"""Hand-written CUDA kernels of the port, one directory per kernel with
the reference's (kernel.py, ops.py, ref.py) layout.  Sources live under
each directory's ``csrc/`` and are built with ``nvcc`` at first use."""
