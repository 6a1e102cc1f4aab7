"""Kernels written by hand for Hopper, each beside its plain PyTorch version.

Layout per kernel: ``kernels/<name>/ops.py`` (wrapper: checks, launch,
launch count), ``kernels/<name>/ref.py`` (plain version, used for CPU
tensors and as the on-card oracle) and the CUDA source under
``csrc/<name>.cu``, built with ``nvcc`` into a plain-C shared library
loaded through ``ctypes``.

    segment_sum — out[k, key, c] = Σ_{r ∈ key} vals[k, r, c]  (every
                  SumProd message emission, and the histogram sweep's
                  segment-⊕ route)
    polymul     — out[b, i] = Σ_j a[b, j] · b[b, (i − j) mod k]  (every ⊗ of
                  the coefficient-domain sketch semiring, PolyCoeff)
    rwkv6_chunk — the chunked RWKV-6 WKV with a carried hs × hs state (every
                  time-mix of an RWKV-6 prefill, ``models/rwkv6.py``)
    flash_attention — softmax(q·kᵀ/√dh)·v, causal or not, GQA by head index
                  (every self-attention of a dense prefill, ``models/layers.py``)

``_build.py`` compiles a ``csrc/<name>.cu`` and loads it, for each.
"""
