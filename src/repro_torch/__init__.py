"""PyTorch/CUDA port of the TorR package ``repro``.

The JAX package ``repro`` is the reference; this package mirrors its layout
and names module for module and never imports it (or JAX). Packed query and
item-memory words are stored as int32 bit patterns of ``repro``'s uint32
words (``convert.py`` crosses between the two).

Entry points (``serving.stream_engine.StreamEngine``,
``kernels.ops.encode_packed``) run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit CPU request they raise.
"""
