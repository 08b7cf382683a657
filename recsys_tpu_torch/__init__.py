"""recsys_tpu_torch — the PyTorch/CUDA port of `recsys_tpu`.

Module names mirror the JAX package (``core/config.py`` here is the
counterpart of ``recsys_tpu/core/config.py``, and so on), so each port
module sits beside its reference. The port imports torch and numpy only;
the JAX package is the reference its tests hold it against.

Ported so far: the xDeepFM Criteo serving path — embedding lookup
(``embeddings``), the dense tower (``ops.nn``), the CIN forward through a
hand-written CUDA kernel (``ops.cin_kernel`` + ``csrc/cin_layer.cu``),
checkpoint and servable I/O in the JAX on-disk format (``core.checkpoint``,
``convert``, ``serve.export``) and the REST server (``serve.server``).
"""

__version__ = "0.1.0"
