"""PyTorch/CUDA port of ``distributed_tensorflow_tpu``.

The JAX package stays the reference; this package mirrors its layout
(``models/gpt.py``, ``ops/attention.py``, ``serving/engine.py`` ...) so
each module's counterpart is found by name.  It imports ``torch`` and
numpy, never JAX and nothing of the JAX package.  The TPU's Pallas
kernels become hand-written CUDA kernels for Hopper (``csrc/``, built at
first use by :mod:`.ops.kernels`).  Entry points run on the GPU unless
the caller passes ``device="cpu"``.
"""
