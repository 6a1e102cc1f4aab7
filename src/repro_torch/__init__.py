"""PyTorch/CUDA port of the relational boosted regression trees system.

Mirrors the module layout of the JAX package ``repro`` (the reference)
and imports nothing of it.  Every entry point runs on ``device="cuda"``
unless the caller passes ``device="cpu"``; on CUDA every SumProd message
emission runs the hand-written segment-⊕ kernel
(``kernels/segment_sum``, source ``csrc/segment_sum.cu``).
"""
