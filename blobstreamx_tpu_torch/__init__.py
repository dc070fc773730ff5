"""PyTorch + CUDA port of the Goldilocks STARK prover in ``blobstreamx_tpu``.

The layout follows the JAX package module for module (``field/``, ``ops/``,
``proof/``, ``chips/``). Each Goldilocks element is one ``torch.int64``
holding the u64 bit pattern; the JAX package's trailing two-limb axis is
dropped (``(c, n, 2)`` u32 there is ``(c, n)`` int64 here, and a GF(p^2)
value ``(..., 2, 2)`` there is ``(..., 2)`` here).

Entry points take a ``device`` argument. ``None`` means the CUDA card; on a
host without one they raise unless the caller asks for ``device="cpu"``,
where every kernel wrapper runs its plain PyTorch version instead.

The hand-written Hopper kernels live in ``csrc/`` and are built with
``nvcc`` at first use (``kernels.py``). Importing this package does no work.
"""
