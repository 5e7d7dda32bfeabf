"""PyTorch + CUDA port of the BLaST reproduction (``src/repro``).

Module layout mirrors the JAX package: ``repro/<x>/<y>.py`` has its twin
at ``repro_torch/<x>/<y>.py``. The port imports torch, numpy and the
standard library only; hand-written Hopper kernels live in ``csrc/`` and
are built by ``nvcc`` at first use (``kernels/build.py``).
"""
