"""PyTorch/CUDA port of ``repro`` (MAESTRO's data-centric cost model and
DSE) for NVIDIA Hopper.  Imports torch and numpy, never JAX or ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a CUDA device they raise rather than fall back (see ``devices``)."""
