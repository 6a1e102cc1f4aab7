"""PyTorch/CUDA port of the relational boosted regression trees system.

Mirrors the module layout of the JAX package ``repro`` (the reference)
and imports nothing of it.  Every entry point runs on ``device="cuda"``
unless the caller passes ``device="cpu"``; on CUDA every SumProd message
emission runs the hand-written segment-⊕ kernel
(``kernels/segment_sum``, source ``csrc/segment_sum.cu``), every ⊗ of the
coefficient-domain sketch the polymul kernel (``csrc/polymul.cu``), and
every WKV of an RWKV-6 prefill (``models/``) the rwkv6_chunk kernel
(``csrc/rwkv6_chunk.cu``).
"""
