"""recsys_tpu_torch — the PyTorch/CUDA port of `recsys_tpu`.

Module names mirror the JAX package (``core/config.py`` here is the
counterpart of ``recsys_tpu/core/config.py``, and so on), so each port
module sits beside its reference. The port imports torch and numpy (and
scipy for the MovieLens sparse matrices), never jax; the JAX package is
the reference its tests hold it against.

Ported so far: the Criteo CTR zoo (FM, DeepFM, DCN, DNN, wide, xDeepFM)
and DIN, trained and served on the card with the TPU kernels written again
for Hopper in CUDA (``csrc/``: the CIN forward and backward, the
embedding-gradient segment sum, the row gather, the reshape probes), the
input pipeline, checkpoints and servables in the JAX on-disk format,
multi-device training on ``torch.distributed``, and the CF family
(``models.vae_cf``, ``train.vae_loop``, ``models.cdae``, ``extras.vi_gmm``,
``data.movielens``, ``tools.train_vae``). The classical models and some
tools are still to come.
"""

__version__ = "0.1.0"
