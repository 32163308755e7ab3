"""PyTorch/CUDA port of the Sentinel serving path (``repro``'s counterpart).

The JAX package ``repro`` is the reference; this package mirrors its module
layout (``configs``, ``kernels``, ``models``, ``serve``) so each module's
counterpart is easy to find.  It imports torch, numpy and the standard
library only — never JAX and nothing of ``repro``.

Entry points (``models.model.init_params``, ``serve.engine.ContinuousBatcher``,
``weights.params_from_jax``) run on the CUDA card unless the caller passes
``device="cpu"``; without a card and without that request they raise.
"""
