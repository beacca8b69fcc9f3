"""PyTorch/CUDA port of the asymmetric embedding data-flow system.

The same layout as the JAX package ``repro`` (``core/``, ``kernels/``,
``data/``, ``models/``, ``serving/``, ``launch/``, ``engine.py``), imported
without JAX.  Entry points run on the card unless the caller asks for the
CPU, where every kernel's plain version runs instead.
"""
