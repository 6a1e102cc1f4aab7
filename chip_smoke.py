#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Kernels vs plain on the card, both built here from
   ``src/repro_torch/csrc/`` (one ``nvcc`` per source, in parallel):
   - the segment-⊕ kernel (``segment_sum.cu``) against its plain PyTorch
     version at the serve path's shapes (C = 3, 40, and 160 for phase 9's
     four stacked models, f32 and bf16; uniform, Zipf-skewed,
     empty-segment and one-key key sets; a key of more than
     ``ops.ITEM_ROWS`` entries is cut into work items, the one key into
     1,024) and at the histogram sweep's (a key column over 2 tiled
     copies of 2^20 stats rows).  Integer-valued inputs must match
     exactly; float inputs must satisfy |kernel − plain_f64|
     ≤ 1e-5 · Σ|v| per output element (Σ|v| over the element's segment,
     in float64).  Prints kernel, plain, ``index_add_`` and bound times;
   - the polymul kernel (``polymul.cu``) against its plain version in
     float64 at the coefficient fit's shapes ((4·2^20, 256) f32 and bf16,
     (2^18, 1024) f32, (1,048,579, 64) f32, a row count off the tile, and
     fit B's broadcast form, a (1, 2^20, 256) factor against (4, 2^20,
     256) messages, f32: all on the tensor cores) and, on the direct form,
     at (4·2^20 + 3, 250) f32.
     Integer-valued inputs must match exactly; float32 within
     2e-5 · (|a| ⊛ |b|) per coefficient, bfloat16 within that plus
     2^-8 · |exact| (the output's rounding).  Prints kernel, plain,
     ``torch.fft`` (the library route, never called by the port on the
     card) and bound times, and the largest |err| / limit;
   - the rwkv6_chunk kernel (``rwkv6_chunk.cu``) against its plain version
     in float64 at the RWKV-6 prefill's shape (8, 1024, 32, 64, c 16), one
     long prompt (1, 4096, 32, 64, 16), one prompt of the prefill's length
     (1, 1024, 32, 64, 16), the reference test's (2, 64, 2, 32, 16) and
     (3, 48, 1, 16, 8) and phase 20 (d)'s tp prefill on a rank's 16 heads
     (8, 1024, 16, 64, 16), on numpy-seeded inputs (standard-normal r, k, v,
     u; log-decays uniform in [−2, −0.01]): |kernel − plain_f64| ≤ 2e-5 · W
     per element, W the plain WKV of |r|, |k|, |v|, |u| with the same
     decays, and the terminal state within 2e-5 per entry of the state of
     |k| and |v| with the same decays; output and state bit-equal on a
     second run.  Prints the sequence segments the wrapper chose, kernel
     (and, where it cut the sequence, the same call in one walk), plain
     (float32) and bound times; no single PyTorch call computes the WKV.
     Then every (hs, c) in one walk and in 4 segments with log-decays of
     −3.3 to −3.7 a token at c 16 (twice that at c 8), which put every
     chunk's cumulative decay just above the −60 where the factored form
     ends, held to the same gates; prints the largest err/W;
   - the WKV backward kernel (``rwkv6_chunk_bwd.cu``) against its plain
     version (``ref.rwkv6_chunk_bwd_ref``) in float64 at phase 11's training
     shape (1, 2048, 32, 64, c 16), phase 20 (d)'s on a tp rank's 16 heads
     (1, 2048, 16, 64, 16), the reference test's (2, 64, 2, 32, 16)
     and (3, 48, 1, 16, 8), and in strong-decay chunks ((1, 256, 2, 64, 16)
     and (1, 128, 2, 32, 8), every chunk decaying by 53–59, just inside the
     −60 clip, or by 80–96, past it) and at the training shape with every
     other chunk decaying by 80–96 (the kernel switching between its
     factored and pairwise decays): dr, dk, dv, dlogw and du each within
     1e-4 · scale per element, the scale ``ref.rwkv6_chunk_bwd_scale`` (the
     same formulas on |r|, |k|, |v|, |u|, |do|, the decays' two cancelling
     sums as magnitudes), and bit-equal on a second run.  Prints the launch
     (the design, the split, CTAs, shared bytes a CTA and CTAs an SM),
     kernel, plain (float32) and bound times; no single PyTorch call
     computes the WKV's gradient;
   - the flash_attention kernel (``flash_attention.cu``) against a dense
     softmax in float64 over the same inputs at the TinyLlama prefill's
     shape (B 8, S 2048, 32 query heads, 4 K/V heads, dh 64, causal) in
     bf16 and in float32, one long prompt (1, 8192, 32, 4, 64), Qwen2.5-32B
     / Llama-3 heads (2, 1024, 40, 8, 128), phase 12's three prefills
     (Granite-3-8B (8, 2048, 32, 8, 128), Qwen2.5-32B (1, 2048, 40, 8, 128)
     and Llama-3-405B (1, 2048, 128, 8, 128): 16 query heads a K/V head), an encoder side (2, 512, 16,
     16, 64, not causal, f32), a ragged S (3, 1000, 8, 2, 32, f32) and the
     smoke config's (2, 24, 8, 1, 16, f32), on numpy-seeded standard-normal
     q, k, v: per element, |kernel − dense_f64| ≤ 2e-5 · max|v| in
     float32, and in bf16 ≤ 2⁻⁷ · (|o| + ‖p‖₂ · max|v|) for an output o of
     a row with probabilities p (the output's rounding, and the
     probabilities' rounding before P·V, which spreads as ‖p‖₂ over a
     row; ``ref.attention_limit``).  Prints kernel, plain (the blockwise
     twin), ``scaled_dot_product_attention`` (the library call, never
     called by the port) and bound times, the kernel's and the library's
     TFLOP/s and their ratio, and the largest |err| / limit.  The
     log-sum-exp output of the training forward, at every shape, within
     1e-4 + 1e-5 · |lse| of a float64 log-sum-exp.  With a sliding window
     (query i sees keys (i − w, i]; the oracle is the softmax over that
     band, the limits the same): Hymba-1.5B's windowed and global
     prefill attentions (8, 2176, 25, 5, 64) at w 1,024 and without, bf16;
     one long prompt (1, 16384, 25, 5, 64) at w 1,024 and causal, whose
     ratio of times is printed beside their ratio of key-query pairs (the
     band's skipped tiles); the float32 twin's shape (1, 2176, 25, 5, 64)
     at w 1,024 and 48; a windowed row also within twice that limit of the
     plain version (two roundings; every row's distance printed).  Phase
     14's training forward, the call that also writes the log-sum-exp, at
     Hymba's microbatch (1, 2176, 25, 5, 64), w 1,024 and causal, bf16
     (timed with its lse; its plain version the blockwise forward with its
     lse, ``plain_attention``), and DBRX-132B's prefill (1, 2048, 48, 8,
     128: 6 query heads a K/V head), bf16, and its training forward with
     the lse (phase 16).  K3, a non-causal call over Sk keys of their own:
     seamless-M4T's encoder self-attention (8, 1024, 16, 16, 64, bf16, Sk
     = S) and its cross-attention (8, 512 queries, 2,048 keys, 16, 16, 64,
     bf16), and an odd float32 shape (2, 40 queries, 70 keys, 8, 2, 32:
     off both tiles); LLaVA-NeXT-34B's prefill (1, 2048, 56, 8, 128, G 7,
     bf16).  Phase 20 (d)'s shapes on a tp rank's 16 local heads of
     TinyLlama's 32 and their 2 K/V heads: the bf16 training forward with
     its lse at a microbatch (1, 2048, 16, 2, 64), the bf16 prefill (8,
     2048, 16, 2, 64) and the float32 twin's training forward with its
     lse (2, 2048, 16, 2, 64); a tp rank's 24 of DBRX's 48 heads and 4 of
     its 8 K/V heads, the bf16 prefill (1, 2048, 24, 4, 128) and the
     training forward with its lse at that shape; a tp rank's 8 of
     seamless-M4T's 16 heads and 8 of its 16 K/V heads, the bf16 prefill's
     encoder (8, 1024, 8, 8, 64, full) and decoder (causal), the
     cross-attention (8, 512 queries, 2,048 keys) and the training forward
     with its lse at a microbatch (1, 1024), full and causal.  A windowed row's bound
     counts the band's pairs, Σ_i min(i + 1, w), and
     its library call is ``scaled_dot_product_attention`` with a boolean
     band mask.  Before the cases, the
     built library's SASS (``cuobjdump``, found beside ``nvcc`` or in
     Triton's package): per bf16 kernel the count of HGMMA (wgmma),
     UTMALDG (TMA loads) and SYNCS (mbarrier) instructions and its shared
     memory, failing if one has no HGMMA or no UTMALDG;
   - the count_sketch kernel (``count_sketch.cu``), both forms (buckets and
     signs as arrays; hashed inside the kernel, the compressor's) at the
     reference test's (n, k) = (100, 16), (1000, 64), (5000, 256), (512,
     128) and at every TinyLlama gradient leaf that the compressor
     sketches: ln_f (2,048, 2⁹), ln1/ln2 (45,056, 2¹³), w_down/w_gate/w_up
     (253,755,392, 2²⁵), wq/wo (92,274,688, 2²⁴), embed (66,060,288, 2²³)
     and wk/wv (11,534,336, 2²¹), and at every RWKV-6 1.6B leaf of phase
     11: ck/cv (352,321,536, 2²⁶: the slabs route, 8 slabs), embed and
     head (134,217,728, 2²⁵), wr/wk/wv/wg/wo/cr (100,663,296, 2²⁴), wA/wB
     (3,145,728, 2¹⁹), mu (245,760, 2¹⁵), mu_c (98,304, 2¹⁴) and the
     vectors (49,152, 2¹³), and at every Hymba-1.5B leaf of phase 14:
     w_up/w_gate/w_down (281,804,800, 2²⁶: slabs, 8 slabs), wq/wo and the
     SSM's wx/wo (81,920,000, 2²⁴), embed and head (51,609,600, 2²³), wB/wC
     (20,480,000, 2²²), wk/wv (16,384,000, 2²¹), wdt (1,280,000, 2¹⁸),
     meta and conv (204,800, 2¹⁵), the norms and Dskip (51,200, 2¹³), ln_f
     (1,600, 2⁸), dt_bias and A_log (800, 2⁷): per bucket j, |kernel − float64| ≤ 2⁻²³ ·
     m_j · W_j (m_j terms, W_j = Σ|x_t| over them; the atomics add in no
     fixed order), the route the plan did not take (bins or slabs, at the
     large leaves) too; the unsketch within 2⁻²³ · |value| of the plain
     version.  Prints the route, kernel (and the other route's), plain
     (int64 hashes and a float64 ``index_add_``), ``index_add_`` with the
     buckets precomputed (the library call, never called by the port) and
     bound times, and the unsketch's time, its library call's
     (``index_select`` of the sketch by the precomputed buckets, times the
     signs and the scale) and its bound.
2. Serve path at real size: star schema with 4,194,304 fact rows and
   4,096-row dimension tables; train 5 trees of depth 3 (sketch mode, no
   SSR), compile, ``score_grouped`` by every table, then 2,000 Zipf(1.3)
   requests through the micro-batching service with a hot swap.  Counts
   must equal the materialized-join oracle exactly and totals must be
   within 1e-4 · Σ|ŷ| of it per group; the kernel's launches must cover
   every message emission the query counters report.
3. Paper check: 262,144 fact rows, 3 trees of depth 3, exact vs sketched
   (k = 256) training with per-table SSR, plus the materialized baseline.
4. The paper's coefficient-domain sketch and histogram splits, at
   1,048,576 fact rows (``--coeff-n-fact``), 3 trees of depth 3:
   A, sketch k = 256 with per-table SSR in the frequency domain;
   B, A in the coefficient domain with A's hashes, whose every ⊗ is the
   polymul kernel: trees identical to A's, SSR within rtol 1e-3 of A's
   where above 1.0, and polymul launches equal to the fit's ⊗ count;
   C, histogram splits (256 bins, the segment-⊕ kernel route) without
   SSR: MSE within 5 % of var(y) of A's exact-split MSE and under half
   of var(y), the kernel route's first-level sweep within 2e-4 of the
   gather route's, and segment-⊕ launches on the histogram route.
   Prints each fit's time and counts, and the device time of one more
   tree of B split into the polymul kernel and the rest.
5. RWKV-6 1.6B serving at its full published width (24 layers, d_model
   2048, 32 heads of 64, d_ff 7168, vocab 65,536, bf16) with random weights
   from a ``torch.Generator`` seed: prefill 8 prompts of 1,024 numpy-seeded
   token ids (each layer's WKV state for the cache comes out of the
   kernel's call), then greedy-decode 64 tokens, after one untimed warm-up.
   Gates: (a) finite logits, padded ids masked; (b) the prefill's
   last-position logits with the plain WKV patched in (the module's
   function, by this script) against the kernel's: in a float32 twin of
   the model (the same weights upcast) within 1e-4 · max|logit| with the
   same greedy tokens, and in bf16 no further apart than the bf16 model
   is from its float32 twin (its own rounding, which 24 layers amplify
   past the reference's 2-layer band); (c) decode_step after
   prefill(S) against prefill(S + 1)'s last-position logits (the oracle
   of ``tests/test_archs.py``): in bf16 no further from the float32
   twin's prefill(S + 1) than twice the bf16 prefill(S + 1) is from it
   in this run (its own rounding; a cache or position fault moves the
   logits by O(1)), the reference's band (atol 0.08, rtol 0.05, from a
   2-layer model) printed only; float32 within 1e-4 · max|logit|; (d) rwkv6_chunk
   launches: one a layer per prefill, none while decoding.  Prints
   prefill ms, decode ms a token and tok/s, and the kernel's share of one
   prefill's device time (torch.profiler); ``--profile`` adds decode's
   idle share.
6. TinyLlama-1.1B dense-attention serving at its full published width and
   depth (22 layers, d_model 2048, 32 query heads and 4 K/V heads of 64,
   SwiGLU d_ff 5632, vocab 32,000, bf16) with random weights from a seed:
   prefill 8 prompts of 2,048 numpy-seeded ids into a KV cache with room
   for the decode tokens, then greedy-decode 64 tokens.  Gates as phase
   5's, with the model's own blockwise attention (the plain version, at
   the config's chunks, q 512 and kv 1024) in place of the kernel for (b),
   whose bf16 half is: at every layer of a bf16 prefill, the kernel's
   output on the model's own q, k, v within phase 1's bf16 limit of a
   dense float64 softmax, and the kernel- and plain-served models' logits
   no further apart than their two distances to the float32 twin added
   (the two bf16 attentions round at different places, so phase 5's bf16
   condition, kernel-vs-plain within the model's distance to its twin, is
   a coin toss here; the per-layer check is the evidence); and (c) at the
   first and the last decode step: decode after prefill(S)
   against prefill(S + t), bf16 at t = 1 as in phase 5, float32 within
   1e-4 · max|logit| at t = 1 and t = 64 (the step that shows the
   cache's room: the reference's S-slot cache has overwritten
   63 prompt positions by then); (d) flash_attention launches 22 times a
   prefill and none while decoding.  Prints the same times and the
   kernel's share of the prefill.

7. TinyLlama-1.1B training at its full published width and depth (bf16,
   random weights from a seed) through ``launch/train.py``'s ``build`` and
   ``launch/steps.make_train_step``: global batch 8 × 2,048 from the
   synthetic pipeline, 8 microbatches, remat, count-sketch gradient
   compression with ratio 8 and error feedback, AdamW; 4 steps after an
   untimed warm-up step.  Gates: (a) a finite loss at every step; (b)
   launches over the 4 steps: flash_attention 22 · 8 · 2 a step (forward
   and remat recompute), count_sketch 12 a step (one a gradient leaf, as
   the reference stacks them) and its unsketch 12, the other kernels 0;
   (c) a float32 twin cut to 4 layers (full width, batch 2 × 2,048, 2
   microbatches), one step served by the kernels and one by the plain
   versions with the same weights, batch and hashes: loss within 1e-5
   relative and each compressed gradient leaf within 1e-4 · max|g|.  The
   two parameter updates are printed, not gated: AdamW's first step is
   g/(|g| + eps), so where a compressed g is a few eps the gradients'
   float noise moves the update by up to ~10 % of max|Δp|; (d) ``launch/train.py``'s ``main`` at the smoke
   size on the card: 3 steps, the checkpoint restored bit for bit, one
   resumed step.  Prints each step's ms and loss, tokens/s, the
   compressor's ms a step (CUDA events) and the peak memory (allocated and
   reserved); ``--profile`` adds one traced step's busy/idle share and
   device time by kind.

8. Incremental maintenance and warm-start retraining, every refreshed
   message a segment-⊕ kernel launch; it runs right after phase 4, on
   the models phases 2 and 4 leave resident, which are freed before
   phase 5.  (a) Phase 2's schema and trees
   (not built or trained again) in a ``MaintainedScorer`` with a
   ``WalWriter`` (fsync every 8 appends) in a temporary directory; 32
   delta batches in ``delta_stream``'s mix, drawn with vectorised numpy:
   6 ops a batch, each on a table drawn uniformly, an insert with p 0.35,
   a delete with p 0.3, else an update, each op a block of rows: on
   ``fact`` 4,096 inserts (keys from the live dimension keys, 1 % newly
   minted), 1,024 deletes or 1,024 feature updates; on a dimension table
   4 inserts (keys the fact table minted, then fresh ones), 4 deletes or
   16 feature updates; batch 17 also inserts 2,048 rows into dim0, which
   must double its capacity.  After each batch
   ``grouped_cached("fact")`` and ``grouped_cached("dim0")``; prints the
   batch's ops, apply, refresh and CSR-rebuild ms (host clock after a
   synchronise), the CSRs built, the edges re-emitted against a full pass
   and the launches, and p50/p99 over the batches.  Gates: after batches
   16 and 32 the recompute oracle of both roots (one effective schema
   each time) bit-equal to the maintained
   scores; during the refreshes segment_sum launches equal to the edges
   the counter records, and more than 0; a snapshot pinned after batch
   19 scores bit-equal to its pin after batch 24; 2,000 Zipf(1.3) row
   requests through the service over the published scorer, each equal to
   ``grouped_cached``'s mean for its row; ``recover_scorer`` from the
   checkpoint of batch 16 and the closed log reaches version 32,
   bit-equal to the live scorer (prints its seconds, the records
   replayed and the log's bytes).  (b) Phase 4's schema: an
   ``IncrementalBooster`` of 3 sketch-mode trees of depth 3, then 4
   ``drift_stream`` batches of 16,384 rows, each followed by a refit of
   one tree: the new tree matches a scratch ``Booster`` on the effective
   schema warm-started from the same trees (``feat`` equal, ``thr`` within
   1e-6, leaves within rtol 1e-4 and atol 1e-5), with fewer edges, and
   the refit's segment_sum launches equal its edges, more than 0 in all.
   Prints refit and scratch seconds (the scratch's effective schema and
   split plans included, and printed apart), the edge ratio and the mask
   signatures' host ms.  No other kernel launches in phase 8.
   ``--profile`` adds one more batch's apply and refresh and one more
   refit, traced, after the gates.

9. The operated service, right after phase 8, on phase 2's schema and
   model; what it allocates is freed before phase 5, and it prints its
   peak memory.  (a) Phase 2's 2,000 Zipf(1.3) requests through
   ``serve_relational``'s own wiring (``wire``, ``drive``, ``finish``)
   with every telemetry flag on: tracing, the SLO
   ``latency=50ms@0.99,errors=0.01,staleness=5s``, a 4,096-span flight
   ring, the telemetry server on 127.0.0.1 port 0 and the sampler into a
   temporary file; half-way through the traffic (the requests wait for it)
   a client thread fetches ``/metricsz``, ``/healthz``, ``/statusz`` and
   ``/tracez`` (10 s timeout), and ``/metricsz`` once more after the last
   request.  Gates: every endpoint answers; the mid-traffic
   ``repro_service_requests`` is below the final one, which equals the
   service's own count; the Chrome
   trace parses and its ``service.batch`` events number the service's
   batches; a forced ``flight.trigger`` writes a dump that parses, with at
   most 4,096 spans; the 2,000 answers bit-equal to phase 2's
   ``grouped_cached`` means (and so are the same requests' answers with
   telemetry off, served first).  Prints QPS and p50/p99 with telemetry on
   and off, the SLO state and burn rates.  (b) Three more variants of phase
   2's model (seeds 7, 8 and 9, shrinkage 1/2, 1/4 and 1/8), all four
   published and stacked by ``registry.stacked()`` into one factor set of
   160 channels, scored by every table: each model's (Σŷ, count) bit-equal
   to its own ``score_grouped`` in float32; segment_sum launches of the
   stacked pass equal to the edges of one pass, and to 4 times that for
   the four separate passes; a bfloat16 stack's leaf counts within 2⁻⁸ ·
   |count| of the float32 stack's; ``stacked()`` the cached object until a
   ``swap``, then a new one.  Prints a stacked pass's ms against the four
   separate passes' per table (CUDA events).  (c) A writer
   ``MaintainedScorer`` over phase 2's model logs phase 8's batches to a
   temporary WAL and checkpoints after batch 8; a replica recovers from
   that checkpoint and log (``recover_scorer``) and a ``WalFollower``
   tails the log (10 ms polls) while the writer applies and refreshes
   batches 9-24, one every 50 ms, on a thread of its own, and a service
   over the replica, with a degrade-only staleness objective and
   ``extra_staleness``, answers Zipf(1.3) requests.  Gates: the follower
   applied through the writer's last LSN; both roots' grouped scores of
   the replica bit-equal to the writer's; 256 service answers equal the
   replica's ``grouped_cached`` means; the staleness objective never
   ``unhealthy``; no request shed or failed; segment_sum launched.  Prints
   the replication lag (per record) p50/p99, the writer's ms a batch and
   the launches.

10. Data parallelism, right after phase 9, on phase 2's schema and model:
   two processes spawned on the one card, both on ``cuda:0``, in a gloo
   group (NCCL puts one card under each rank; gloo stages every
   collective through the host), each rank holding a row block of every
   table the world size divides.  The parent hands the ranks phase 2's
   columns (labels snapped to 1/16, so every label sum is exact in
   float32; scores do not read labels), trees and scores; each rank
   builds the schema itself.  With the counts at 0, each rank runs (a)
   phase 2's trees compiled under the mesh, ``score_grouped`` by every
   table; (b) phase 2's fit config (5 trees, depth 3, sketch, no SSR)
   on the first ``DP_FIT_ROWS`` = 2¹⁸ of its 2²² fact rows (the whole
   table took 61-77 s over the host, most of it all-gathers of
   fact-sized grouped outputs, whose bytes scale with the rows; 2²⁰
   took 19.7-22.1 s, 2¹⁹ 15.8 s, cut to 2¹⁸ for (d)'s time and phase 20
   (d)'s (2, 1) part);
   (c) a ``MaintainedScorer`` through 4 ``delta_stream`` batches of 8
   ops (labels snapped), both roots after each; then, outside the count,
   the one-process fit and scorer.  Gates on every rank: (a) ``tot`` and
   ``cnt`` bit-equal to phase 2's; (b) trees equal to the one-process
   fit's; (c) both roots bit-equal to the one-process scorer's after
   every batch; segment_sum launches = the counters' edges, and the fact
   table's factor a row block.  A rank that fails, or a world not joined
   within 600 s, fails the phase.  Prints per rank the all-reduce ms a
   message (p50/p99 of its spans) and its bytes, the all-gather ms a
   grouped output, each pass's ms against phase 2's, the fits' seconds,
   the delta batches' ms and the peak memory, and the phase's seconds.
   Two ranks sharing one card through the host measure correctness and
   the collectives' host cost, not the speed of several cards.  (d) The
   WAL follower on the mesh (``serve_relational.open_mesh_follower``,
   ``incremental.wal.MeshFollower``): before the spawn this process, a
   one-process writer over phase 2's schema and model, applies phase 8's
   batches 1-10 to a log, checkpointing after batch 8; after (a)-(c),
   with the counts at 0, every rank loads the checkpoint rank 0 picked
   and one round of broadcast records brings both to LSN 10; then, while
   this process's writer thread applies batches 11-26 (one every 50 ms,
   batch 17 growing dim0 by 2,048 rows: a capacity laid out again on the
   mesh), rank 0 tails the log and broadcasts each poll, every rank
   applies each record and scores both roots on the new version's
   snapshot before rank 0's service may see it, and rank 0 serves
   Zipf(1.3) requests with a degrade-only staleness objective.  Gates on
   every rank: recovered at LSN 10 from checkpoint 8 and applied through
   26, the writer's; at the checkpoint and after each record both roots
   bit-equal to a one-process follower's (the checkpoint, then each
   record alone); segment_sum launches = the rank's counter's edges; on
   rank 0, 256 answers equal to the means of the version they were
   served at, the staleness objective never ``unhealthy``, nothing shed
   or failed.  Prints per rank the recovery's seconds, the apply ms and
   the publication ms a record (p50/p99), the all-reduce, all-gather and
   broadcast ms of the tail (spans), and rank 0's replication lag a
   record (p50/p99).

11. The paper's pipeline stage feeding LM training (the reference's
   ``examples/relational_data_pipeline.py``), on phase 4's resident star
   (1,048,576 fact rows, one a document; cut from phase 2's 2²² for phase
   4's reason: a (4, 2²², 257) complex sketch factor is ~16 GiB).  (a)
   After phase 7: ``configs.get("paper_rbrt")`` (depth 4, sketch k 256,
   per-table SSR; its 8 trees cut to ``BRIDGE_TREES`` = 4 for phase 20
   (d)'s time) fitted, then ``relational_example_weights``
   by ``fact`` (one compiled pass).  Gates: segment_sum launches equal the
   message emissions (edges) of the fit and of the pass (the join tree's,
   tables − 1), each emission counted where ``SumProd`` makes it (under
   per-table SSR the ``QueryCounter``'s analytic edges, printed, count more
   than are emitted); the weights within rtol expm1(2·D) + 1e-5 of the softmax of the
   float64 oracle's means (materialize_join + predict_rows + bincount), D
   the largest error phase 2's gate allows a mean, 1e-4·Σ|ŷ| / count (plus
   float32's least normal number, where a weight underflows); Σw = 1
   within 1e-6.  Prints fit s, pass ms, the weights' min and max and
   their effective sample size 1/Σw².  (b) Right after (a): ``launch/
   train.py``'s ``build`` for ``--arch rwkv6_1_6b --full`` (24 layers, d
   2,048, 32 heads of 64, vocab 65,536, bf16, ~1.58 B parameters, random
   from a seed), its pipeline ``TokenPipeline(65536, 8, 2048, seed=1,
   example_weights=w)``; 8 microbatches, remat, compression 8 with error
   feedback, AdamW; ``RWKV_STEPS`` = 2 steps (4 before phase 20 (d)'s
   MoE and RWKV parts needed the time) after an untimed warm-up step.
   Gates: a finite loss every step; launches over the steps: rwkv6_chunk 2 · 24 · 8 a
   step (forward and remat recompute), its backward 24 · 8, count_sketch
   and its unsketch once a gradient leaf of 32 elements or more, the
   other kernels 0; the warm-up batch's ``doc_ids`` equal to a CPU
   ``TokenPipeline``'s for the same weights and seed; a float32 twin cut to
   4 layers (full width, 2 × 2,048, 2 microbatches), one step served by the
   kernels and one by the plain versions (autograd through the plain WKV)
   with the same weights, batch and hashes: loss within 1e-5 relative and
   each compressed gradient leaf within 1e-4 · max|g|.  Prints each step's
   ms and loss, tokens/s, the compressor's ms, the peak memory; with
   ``--profile`` one traced step's device time by kernel kind.

12. Three dense configs served on the flash_attention kernel, the card
   emptied of every earlier phase's model first: Granite-3-8B (40 layers,
   d 4,096, 32 heads and 8 K/V heads of 128, tied 49,155-id vocab padded to
   49,664; prefill 8 × 2,048), Qwen2.5-32B (64 layers, d 5,120, 40 and 8
   heads of 128, QKV bias, θ 1e6; prefill 1 × 2,048; ~61 GiB of weights)
   and Llama-3-405B cut to 8 of its 126 layers (d 16,384, 128 heads over 8
   K/V heads, θ 5e5; prefill 1 × 2,048; the cut keeps it on one card),
   bf16, random weights from a seed, each then greedy-decoding 64 tokens
   into a cache with room for them, through phases 5 and 6's serving
   function.  Before each full model, a float32 twin at full width cut to
   2 layers (the first prompt, 1 × 2,048), freed after.  Gates:
   (a) finite logits, padded ids masked; (b) in the twin, the kernel-served
   prefill against the plain-served one within 1e-4 · max|logit| with the
   same greedy tokens, and in the full bf16 model every layer's kernel
   output on the model's own q, k, v within 2⁻⁷·(|o| + ‖p‖₂·max|v|) of a
   float64 softmax (phase 6's per-layer gate); (c) in the twin, decode
   after prefill(S) against prefill(S + t) within 1e-4 · max|logit| at t
   = 1 and t = 64; in the bf16 model the first decode step no further from
   the kernel-served prefill(S + 1) than twice the plain-served
   prefill(S + 1) is from it (two bf16 roundings of one function; a cache
   or position fault moves logits by O(1)); (d) flash_attention once a
   layer a prefill, never while decoding.  Prints prefill ms, decode ms a
   token and tok/s, flash_attention's share of the prefill's device time
   and the peak memory.

13. Hymba-1.5B (``hymba_1_5b``, arXiv:2411.13676) served at its full
   published width and depth (32 layers, d 1,600, 25 query and 5 K/V heads
   of 64, d_ff 5,504, vocab 32,001, 25 SSM heads of state 16, chunk 16,
   128 meta tokens, a window of 1,024 on every layer but 0, 15 and 31;
   bf16), random weights from a seed, the card emptied first, through
   phase 12's serving function: prefill 8 × 2,048 ids (2,176 positions
   with the meta tokens, so the window bites) into a cache with room for
   64 decode tokens, then 64 greedy tokens.  Before it, a float32 twin at
   full width cut to 2 layers with layer 0 global (one windowed layer and
   one global layer), on the first prompt.  Gates as phase 12's: (a)
   finite logits; (b) the twin's kernel-served prefill within 1e-4 ·
   max|logit| of its plain-served one, the same greedy tokens; every bf16
   layer's attention within 2⁻⁷·(|o| + ‖p‖₂·max|v|) of the float64 band
   oracle; (c) the twin's decode ≡ prefill(S + t) at t = 1 and 64 (1e-4 ·
   max|logit|), the bf16 decode within twice the plain-served
   prefill(S + 1)'s distance; (d) 32 flash_attention launches a prefill,
   none in decode.  Prints prefill ms and its idle share, the prefill's
   device time by kind with the SSM branch (its ``record_function``
   range ``ssm_branch``) as a kind of its own, decode ms a token, tok/s
   and the peak memory.

14. Hymba-1.5B trained at its full published width and depth (bf16,
   random weights from a seed), the card emptied first, through
   ``launch/train.py``'s ``build`` and ``launch/steps.make_train_step``:
   global batch 8 × 2,048 tokens (2,176 positions a row with the 128 meta
   tokens), 8 microbatches, remat, count-sketch compression 8 with error
   feedback, AdamW; ``HYMBA_STEPS`` = 1 step (4 before phase 20 (d) needed
   the time, 2 before its (2, 1) part) after an untimed warm-up step.  Every training
   attention's forward is the flash_attention kernel with the layer's
   window and its lse; its backward is the plain ``ref.block_attn_bwd``
   over the window's band (the reference has no backward kernel).  Gates:
   a finite loss every step; over the 4 steps flash_attention 2 · 32 · 8
   = 512 times a step, 2 · 29 · 8 = 464 of them windowed (the wrapper's
   ``windowed_launches``), count_sketch and its unsketch once a sketched
   leaf a step, the other kernels 0; phase 1 held count_sketch at every
   (n, k) the compressor sketches; a float32 twin cut to 2 layers (layer
   0 global, layer 1 windowed: the band bites at 2,176 positions), 2 ×
   2,048 tokens, 2 microbatches, one step served by the kernels and one by
   the plain versions with the same weights, batch and hashes: loss within
   1e-5 relative and each compressed gradient leaf within 1e-4 · max|g|.
   Prints each step's ms and loss, tokens/s, the compressor's ms, the peak
   memory, and one traced step's idle share and device time by kind, the
   SSM branch (its forward and remat recompute, ``record_function``
   ``ssm_branch``, and its backward, between the marks
   ``ssm_branch.bwd_begin`` and ``.bwd_end``) and the attention backward
   (``attention_bwd``) as kinds of their own.

15. MoE serving at full width, the card emptied before each model:
   DBRX-132B (d 6,144, 48 query and 8 K/V heads of 128, 16 experts of d_ff
   10,752, top 4, vocab 100,352) and Llama-4-Scout-17B-16E (d 5,120, 40 and
   8 heads of 128, 16 experts of d_ff 8,192, top 1 and a shared expert, θ
   5e5, vocab 202,048), each cut to 8 layers (of 40 and 48) as Llama-3-405B
   in phase 12, bf16, random weights from a seed, through phase 12's
   serving function: prefill 1 × 2,048 into a cache with room for 64
   decode tokens, then 64 greedy tokens, every block's FFN the MoE at
   capacity factor 4.0 (the reference's serving factor).  Before each, a
   float32 twin at full width cut to 2 layers, freed before the bf16 model.
   Gates as phase 12's: (a) finite logits; (b) the twin's kernel-served
   prefill within 1e-4 · max|logit| of its plain-served one, the same
   greedy tokens, and every bf16 layer's attention within 2⁻⁷·(|o| +
   ‖p‖₂·max|v|) of float64; (c) the twin's decode ≡ prefill(S + t) at t =
   1 and 64 (1e-4 · max|logit|), the bf16 decode within twice the
   plain-served prefill(S + 1)'s distance; (d) flash_attention once a layer
   a prefill, none in decode; and before (b) and (c), in the twin and in
   the model, no (token, expert) pair of the prefill dropped (decode ≡
   prefill(S + t) means nothing where one is).  Prints the routing
   (capacity, tokens dropped and each expert's load by layer), prefill ms,
   its idle share and device time by kind with the expert products
   (``record_function`` ``moe_experts``: their three GEMMs and the SwiGLU)
   as a kind of their own, decode ms a token, tok/s and the peak memory.

16. MoE training at full width, each of DBRX-132B and Llama-4-Scout cut to
   1 layer (a layer with its untied embedding and head: ~4.49 B and ~4.27
   B parameters, 62.9 and 59.8 GB of bf16 weights, AdamW moments and
   float32 accumulators, so no compressor: its error feedback would take
   DBRX past the card), the card emptied first, through ``launch/train.py``'s
   ``build`` (``--layers 1``): global batch 8 × 2,048, 8 microbatches,
   remat, AdamW, 4 steps after an untimed warm-up step, the MoE FFN at the
   config's capacity factor (1.25 and 1.5), ``models/moe.route`` recorded
   on every call.  Gates: a finite loss every step; 16 flash_attention
   launches a step (1 layer × 2 under remat × 8), the other kernels 0; every
   block's remat recompute routes each (token, choice) as its forward did;
   a float32 twin (1 layer, full width, 1 × 2,048, remat) whose gradient
   stage is served once by the kernel and once by the plain attention with
   the same weights and batch, the plain run replaying the kernel run's
   routing (``moe.route(..., expert=...)``: float32 rounding of the two
   attentions may flip a top-k choice): loss within 1e-5 relative, every
   gradient leaf within 1e-4 · max|g|.  Prints the reckoning of its depth
   and bytes, each step's ms and loss, tokens/s, the peak memory, tokens
   dropped and the experts' load by layer, one traced step's idle share
   and device time by kind (the expert products ``moe_experts`` and the
   attention backward ``attention_bwd`` kinds of their own), and the
   choices that would have differed untied.

17. seamless-M4T-medium (arXiv:2308.11596; 12 encoder and 12 decoder
   layers, d 1,024, 16 heads of 64, d_ff 4,096, GELU, vocab 256,206 padded
   to 256,512; ~0.88 B parameters) served at full width and depth through
   phase 12's serving function, the card emptied first: prefill 8 × (1,024
   frames + 1,024 tokens) (``src_frames`` N(0, 0.02²) from the prompt's
   rng) into a cache with room for 64 decode tokens, then 64 greedy tokens,
   each decoder block cross-attending to the encoder's output (prefill:
   the kernel, non-causal, Sk the frames; decode: its cached k, v, plain).
   Before it, a float32 twin cut to 2 + 2 layers.  Gates as phase 12's,
   every encoder self-attention, decoder self-attention and
   cross-attention in bf16 held to the float64 oracle (non-causal where it
   is); 36 flash_attention launches a prefill, 24 of them non-causal, none
   in decode.

18. seamless-M4T-medium trained at full width and depth as phase 7 (8
   rows of 1,024 frames + 1,024 tokens, ``launch/train.make_batch_for``'s
   split, 8 microbatches, remat, compression 8, AdamW, 4 steps after a
   warm-up), the card emptied first.  Gates: a finite loss every step; 576
   flash_attention launches a step (36 a forward × 2 under remat × 8), 384
   non-causal; count_sketch and its unsketch once a sketched leaf a step
   (the 256,512 × 1,024 embedding and head are under 2³¹ elements); a
   float32 twin (2 + 2 layers, 2 rows, 2 microbatches) kernel- against
   plain-served: loss within 1e-5 relative, compressed gradients within 1e-4
   · max|g| a leaf.  Prints the reckoning, step ms, tokens/s, compressor
   ms, peak memory and a traced step's idle share and device time by kind
   (``attention_bwd`` its own).

19. LLaVA-NeXT-34B (60 layers, d 7,168, 56 query and 8 K/V heads of 128:
   7 a K/V head, d_ff 20,480, vocab 64,000, θ 1e6; 34.4 B parameters, 68.8
   GB of bf16 weights) served at its full depth unless the reckoning of
   its weights and 8 GiB of room passes the card's memory (then cut, and
   said), through phase 12's serving function, the card emptied first:
   prefill 1 × (1,024 patch embeddings + 1,024 tokens), ``patches`` N(0,
   0.02²) before the tokens, then 64 greedy tokens.  Before it, a float32
   twin cut to 2 layers.  Gates as phase 12's; one launch a layer a
   prefill, none in decode.

20. Placement, the card emptied first.  (a) TinyLlama-1.1B at full width,
   cut to 4 of its 22 layers (for phase 20 (d)'s time), trained by
   ``launch/train.py``'s ``run`` (what ``main`` runs: ``--full --layers 4
   --steps 2 --batch 8 --seq 2048 --n-micro 8 --compress-grads 8
   --ckpt-every 0``) on ``make_host_mesh()``, (1, 1)
   on the one card, the parameters, AdamW's state and every batch placed
   as DTensors by the reference's rules, after the plain trainer twice on
   the same seed and batches.  Gates: 2 · 4 · 8 = 64 flash_attention, 12
   sketch and 12 unsketch launches a step on the placed run (the counts set to 0 just
   before it, read just after); losses and grad norms bit-equal to both
   plain runs'; parameters apart in at most ``PLACED_APART`` of the
   elements, each by at most 2·Σlr plus a bf16 rounding flip, for the
   placed run and for the plain rerun alike (the count_sketch kernel's
   atomic sums change a compressed gradient's last bits from run to run,
   and AdamW's first steps amplify that where a compressed g is tiny).
   Prints the step ms of the placed run and of the second plain run (the
   placement's overhead), tokens/s and peak memory.  (b) The run's final
   blocking checkpoint restored by ``runtime/elastic.
   restore_elastic`` onto ``rebuild_mesh(1)``, bit for bit.  (c) Two
   dry-run cells at full size, each through ``launch/dryrun.py``'s CLI in
   a subprocess within 300 s: TinyLlama × train_4k × 16x16 (256 fake
   ranks) and Llama-3-405B × decode_32k × 2x16x16 (512); their
   ``arguments`` must equal this script's own sum over the rules, and the
   training cell's census must hold at least one all-gather a sharded leaf
   a microbatch.  Prints each record's bytes, flops, census and
   ``lower_s``.  The cells need no card: they start right after the build,
   run beside phases 1-19 on two of the host's cores, and are collected
   here.  Four more cells, DBRX-132B × prefill_32k × 16x16, RWKV-6 ×
   train_4k × 16x16, Hymba-1.5B × train_4k × 16x16 and seamless-M4T-medium
   × train_4k × 16x16 (256 each), the MoE one expert-parallel.  All six run
   tensor- and sequence-parallel over the 16 "model" ranks.  Hymba's and
   seamless's cells also run on the gathered path (``tp.context``
   returning None: each block's weights gathered whole, the ranks of a tp
   group computing the same rows; what the parent commit ran for these
   kinds), and their FLOPs a rank must stay below the gathered path's
   (seamless's at most 1/8 of it), peak live bytes printed beside.  DBRX's
   cell runs again on a 1x16 mesh (one dp rank, the same tp): its FLOPs a
   rank times its dp of 16 must stay within 1 + 1e-3 of that cell's (a
   dp rank's expert buffer holds its own tokens' pairs alone).  (d)
   Tensor, sequence and expert parallelism on the card
   (``distributed/tp.py``, ``models/moe.moe_ffn_tp``, RWKV-6's heads,
   Hymba's attention and SSM heads, seamless's encoder and
   cross-attention over tp): two processes
   spawned on ``cuda:0`` in a gloo group on a (1, 2) mesh, every
   collective staged through the host (the transport for two ranks sharing
   one card; its times are gloo's through the host, not NVLink's).
   ``TP_PARTS`` lists the configurations, each at full width:
   TinyLlama-1.1B (cut to 2 of its 22 layers for the script's time),
   DBRX-132B (1 layer trained, 2 served), Llama-4-Scout (2 layers served),
   RWKV-6 1.6B (4 of 24 layers), Hymba-1.5B (2 of 32 layers trained, 4
   served: layer 0 global, the others windowed; 128 meta positions before
   each row's 2,048 tokens; its 25 attention and 25 SSM heads run whole on
   each rank, as tp 2 divides neither) and seamless-M4T-medium (2 + 2 of
   12 + 12 layers trained, 4 + 4 served; each row 1,024 frames and 1,024
   tokens).  This process first makes the references and frees them, part
   by part: the plain trainer's two bf16 steps on the run's seed and
   batches (TinyLlama, RWKV-6 and Hymba: 4 × 2,048, 4 microbatches,
   compression 8; DBRX and seamless: 4 × 2,048, 4 microbatches, no
   compression), and the plain-served bf16 model's prefill (TinyLlama,
   Hymba and seamless 8 × 2,048, DBRX and Scout 1 × 2,048, RWKV-6 8 ×
   1,024) and 16 greedy decode steps beside its float32 twin's (the same
   weights upcast, the same tokens fed).  Each rank then runs, part by
   part: (1) a float32 gradient stage of the model (TinyLlama, Hymba and
   seamless at 2 layers (2 + 2), RWKV-6 at 4, all 2 × 2,048, DBRX at 1
   layer and 1 × 2,048) on the mesh against the plain one-process
   stage on the same seed and batch, the ranks taking the plain stage in
   turns and keeping their shard's slice of its gradient on the host, an
   MoE's routing replayed from the plain run (the choices its own top-k
   would have made otherwise counted): loss within 1e-5 relative, every
   gradient leaf within 1e-4·max|g|; then, the counts at 0 before each run
   and read after it, (2) two bf16 steps of the plain trainer's
   configuration through ``launch/train.py``'s ``build`` on the mesh:
   losses finite, step 1's within 1e-2 relative of the plain trainer's,
   flash_attention 2 · 4 launches a step an attention (twice a microbatch
   forward under remat; seamless's encoder and cross-attention apart as
   the non-causal ones, Hymba's windowed layer apart) on the rank's half
   of the heads (TinyLlama 16, DBRX 24, seamless 8; all of Hymba's 25),
   RWKV-6's WKV 2 · 4 · 4 forwards and 4 · 4 K1 backwards a step on 16 of
   its 32 heads, a sketch and an unsketch a sketched leaf a step, an
   MoE's every remat recompute routed as its forward; (3)
   ``steps.placed_prefill`` of the part's prompt with room for 16 tokens,
   one launch an attention on the rank's heads (an MoE prefill dropping no
   (token, expert) pair at factor 4.0), then 16 ``placed_decode`` steps of
   the fed tokens, no launch: every step's logits (rank 0's, gathered) no
   further from the float32 twin's than 2× the plain-served bf16 model's
   largest distance to them.  Prints per rank and part the step ms,
   prefill ms, decode ms a token, peak memory, the shards' shapes, an
   MoE's experts held, drops and loads, and the bytes staged through the
   host with the host seconds by stage.  Then the (2, 1) part
   (``TP_DP``): DBRX-132B at full width cut to 1 layer, bf16, on a (2, 1)
   mesh of the same two ranks (dp 2: each rank its slice of the
   microbatch, ``sharding.place_batch``; every MoE route over the dp
   group's whole microbatch, ``moe.route(..., dp=)``), one gradient stage
   of a 4 × 2,048 microbatch at the training factor 1.25 and a 2 × 2,048
   prefill at the serving factor 4.0, every route recorded (its router
   input, choices, ranks, keep mask and C).  This process first runs the
   one-process stage on the same weights and microbatch.  Gates: each
   route call's C, ranks and keep mask equal to the one-process route of
   the same microbatch's router inputs (the ranks' rows in dp order) with
   the ranks' choices, and the choices its own top-k's but where two
   probabilities tie within 1e-5; the remat recompute routed as its
   forward; the stage's loss finite and within 1e-2 relative of the
   one-process stage's; flash_attention twice in the stage and once in
   the prefill on all 48 heads; the prefill's logits finite.  Prints the
   pairs dropped at 1.25 (by rank: the later rows' first), the stage's
   and the prefill's ms, bytes staged and peak memory.

Prints the card's name and power limit, the build time, each phase's
findings, a JSON line of kernel measurements, and as its last line
``{"ok": true, "device": {...}}``.  A failure ends the run where it
happens.  Needs a CUDA device and the repository's ``src/`` beside it.
"""
from __future__ import annotations

import argparse
import asyncio
import bisect
import contextlib
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM published HBM3 rate
F32_OPS_PER_S = 67e12              # H100 SXM published float32 rate outside the tensor cores
FLOAT_RTOL = 1e-5                  # float inputs: |err| ≤ FLOAT_RTOL · Σ|v| per element
POLY_RTOL = 2e-5                   # polymul: |err| ≤ POLY_RTOL · (|a| ⊛ |b|), f32 sums of k products
BF16_ULP = 2.0 ** -8               # bf16 output rounding, relative
WKV_RTOL = 2e-5                    # rwkv6_chunk: |err| ≤ WKV_RTOL · W, W the WKV of |r|, |k|, |v|, |u|
BF16_OPS_PER_S = 989e12            # H100 SXM published dense bf16 tensor-core rate
LM_BAND = dict(atol=0.08, rtol=0.05)   # the reference's bf16 band (tests/test_archs.py), printed
DECODE_NOISE = 2.0                 # bf16 decode: |Δ| to the f32 twin ≤ this × bf16 prefill's
LM_F32_RTOL = 1e-4                 # float32 LM logits: |Δ| ≤ LM_F32_RTOL · max|logit|
LSE_ATOL, LSE_RTOL = 1e-4, 1e-5    # flash lse: |err| ≤ LSE_ATOL + LSE_RTOL · |lse|
PLAIN_FACTOR = 2.0                 # windowed flash rows: |kernel − plain| ≤ this × the f64 limit
SKETCH_ROUND = 2.0 ** -23          # count_sketch: |err_j| ≤ SKETCH_ROUND · m_j · W_j per bucket
TRAIN_LOSS_RTOL = 1e-5             # float32 twin: kernel- vs plain-served step, loss
TRAIN_GRAD_RTOL = 1e-4             # ... compressed gradient, of max|g| per leaf
TRAIN_STEP_RTOL = 1e-4             # ... share of updates apart by more (printed only)
WKV_BWD_RTOL = 1e-4                # rwkv6_chunk_bwd: |err| ≤ this · rwkv6_chunk_bwd_scale
N_KEYS = 4096                      # dimension-table key domain of the serve path


T_START = time.perf_counter()


def log(msg: str) -> None:
    """Print ``msg``; a phase's header with the seconds since the start."""
    if msg.startswith("phase "):
        msg = f"[{time.perf_counter() - T_START:.0f}s] {msg}"
    print(msg, flush=True)


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, min_total_s: float = 0.2, max_reps: int = 20, min_reps: int = 3) -> float:
    """Mean milliseconds per call from CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = int(min(max_reps, max(min_reps,
                                 min_total_s / max(time.perf_counter() - t0, 1e-6))))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------------ phase 1 --
def make_ids(rng, n: int, n_keys: int, dist: str) -> np.ndarray:
    if dist == "uniform":
        return rng.integers(0, n_keys, n)
    if dist == "zipf":                                  # one very long segment
        return np.minimum(rng.zipf(1.3, n) - 1, n_keys - 1)
    if dist == "even":                                  # every odd key is empty
        return 2 * rng.integers(0, n_keys // 2, n)
    if dist == "one":                                   # every row on one key
        return np.full(n, n_keys // 2)
    raise ValueError(dist)


def kernel_case(ops, ref, name, K, n, C, dtype, dist, n_keys=N_KEYS, seed=0, dev="cuda",
                tiles=1):
    """One shape: exactness on integer values, tolerance on float values,
    determinism, and timings.  Returns the shape's record.  ``tiles`` > 1
    is the histogram sweep's shape: a key column over that many tiled
    copies of the n rows (``bins + f·(B+1)``, the last bin of each copy
    empty), read in place through a CSR whose order is taken modulo n."""
    rng = np.random.default_rng(seed)
    if tiles > 1:
        nb = n_keys // tiles
        ids = (rng.integers(0, nb - 1, (tiles, n)) + np.arange(tiles)[:, None] * nb).reshape(-1)
        seg = ops.Segments.from_ids(ids, n_keys, dev, row_period=n)
    else:
        seg = ops.Segments.from_ids(make_ids(rng, n, n_keys, dist), n_keys, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    ints = torch.randint(0, 4, (K, n, C), generator=gen, device=dev).to(dtype)
    got = ops.segment_sum(ints, seg)
    want = ref.segment_sum_ref(ints, seg.order, seg.offsets, torch.float64)
    if not torch.equal(got.double(), want):
        raise AssertionError(f"{name}: integer-valued sums differ "
                             f"(max |err| {float((got.double() - want).abs().max())})")

    vals = torch.randn((K, n, C), generator=gen, device=dev).to(dtype)
    got = ops.segment_sum(vals, seg)
    again = ops.segment_sum(vals, seg)
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two runs of the kernel differ")
    want = ref.segment_sum_ref(vals, seg.order, seg.offsets, torch.float64)
    mag = ref.segment_sum_ref(vals.abs(), seg.order, seg.offsets, torch.float64)
    err = (got.double() - want).abs()
    if bool((err > FLOAT_RTOL * mag + 1e-30).any()):
        raise AssertionError(f"{name}: float sums outside {FLOAT_RTOL}·Σ|v| "
                             f"(max |err| {float(err.max())})")
    max_abs_err = float(err.max())
    del ints, want, mag, err, again

    kernel_ms = cuda_ms(lambda: ops.segment_sum(vals, seg))
    plain_ms = cuda_ms(lambda: ref.segment_sum_ref(vals, seg.order, seg.offsets),
                       max_reps=5)
    # yardstick only: one PyTorch call computing the same sums (atomics);
    # bf16 input accumulates into a bf16 output, index_add_'s only option;
    # the tiled values of the histogram shape are built outside the timing
    out_dtype = torch.float32 if dtype == torch.float32 else dtype
    lib_out = torch.zeros((K, n_keys, C), dtype=out_dtype, device=dev)
    lib_vals = vals.repeat(1, tiles, 1) if tiles > 1 else vals
    library_ms = cuda_ms(lambda: lib_out.zero_().index_add_(1, seg.ids, lib_vals))
    in_bytes = vals.element_size()
    entries = tiles * n
    nbytes = K * n * C * in_bytes + 4 * entries + 4 * (n_keys + 1) + 4 * K * n_keys * C
    # the least time for the same work: bytes (each input read once, the
    # output written once) or the K·n·C float32 adds, whichever is larger
    bound_ms = max(nbytes / HBM_BYTES_PER_S, K * n * C / F32_OPS_PER_S) * 1e3
    rec = {"case": name, "K": K, "n": n, "C": C, "n_keys": n_keys, "tiles": tiles,
           "dtype": str(dtype).replace("torch.", ""), "ids": dist,
           "max_segment": int(torch.diff(seg.offsets).max()),
           "max_abs_err": max_abs_err, "ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms, "bytes": nbytes}
    log(f"  {name:<22} K={K} n={n} C={C} {rec['dtype']:<8} ids={dist:<7} "
        f"kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.4f}  library_ms {library_ms:.4f}  "
        f"bound_ms {bound_ms:.4f}  max_abs_err {max_abs_err:.3e}")
    del vals, got, lib_out, lib_vals
    torch.cuda.empty_cache()
    return rec


def phase_kernel(ops, ref, dev="cuda"):
    n22, n18 = 1 << 22, 1 << 18
    cases = [
        ("c3_k1", 1, n22, 3, torch.float32, "uniform"),
        ("c3_k4", 4, n22, 3, torch.float32, "uniform"),
        ("leaves40_f32", 1, n22, 40, torch.float32, "uniform"),
        ("leaves40_bf16", 1, n22, 40, torch.bfloat16, "uniform"),
        ("stacked160_f32", 1, n22, 160, torch.float32, "uniform"),     # phase 9's A/B stack
        ("stacked160_bf16", 1, n22, 160, torch.bfloat16, "uniform"),
        ("polyfreq256_k4", 4, n18, 258, torch.float32, "uniform"),
        ("c3_zipf", 1, n22, 3, torch.float32, "zipf"),
        ("leaves40_zipf", 1, n22, 40, torch.float32, "zipf"),
        ("c3_empty_segments", 1, n22, 3, torch.float32, "even"),
        ("leaves40_empty_segments", 1, n22, 40, torch.float32, "even"),
        ("c3_one_key", 1, n22, 3, torch.float32, "one"),
        ("leaves40_one_key", 1, n22, 40, torch.float32, "one"),
    ]
    recs = [kernel_case(ops, ref, *c, dev=dev) for c in cases]
    # phase 4's histogram sweep on the fact table: 2 features × 257 bin
    # slots, stats of K = 4 nodes (C = 2K) over 2^20 rows
    recs.append(kernel_case(ops, ref, "hist_fact_k4", 1, 1 << 20, 8, torch.float32, "bins",
                            n_keys=2 * 257, dev=dev, tiles=2))
    return recs


def poly_case(ops, ref, name, B, k, dtype, seed=0, dev="cuda", chunk=1 << 18, bcast=1):
    """One polymul shape: exactness on integer values, tolerance on float
    values against the float64 plain version (computed ``chunk`` rows at
    a time), determinism, and timings.  Returns the shape's record.
    ``bcast`` > 1 is fit B's broadcast form: a (1, B/bcast, k) factor
    against (bcast, B/bcast, k) messages, the factor read in place."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    chunks = [slice(r, min(r + chunk, B)) for r in range(0, B, chunk)]
    a_shape, b_shape = (1, B // bcast, k), (bcast, B // bcast, k)
    rows = lambda x: x.expand(b_shape).reshape(B, k)     # the rows the kernel reads
    # integers in {−lo..lo}: every partial sum (|·| ≤ lo²·k) is exact in the dtype
    lo = 2 if dtype == torch.float32 else 1
    if dtype == torch.float32 or k <= 256:
        ia, ib = (torch.randint(-lo, lo + 1, shape, generator=gen, device=dev).to(dtype)
                  for shape in (a_shape, b_shape))
        got = ops.poly_mul(ia, ib).reshape(B, k)
        ia, ib = rows(ia), ib.reshape(B, k)
        for c in chunks:
            want = ref.poly_mul_ref(ia[c], ib[c], torch.float64)
            if float((want - want.round()).abs().max()) > 1e-6:
                raise AssertionError(f"{name}: float64 plain version is off the integers")
            if not torch.equal(got[c].double(), want.round()):
                raise AssertionError(f"{name}: integer-valued products differ "
                                     f"(max |err| {float((got[c].double() - want).abs().max())})")
        del ia, ib, got, want
    a, b = (torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in (a_shape, b_shape))
    got = ops.poly_mul(a, b)
    if not torch.equal(got, ops.poly_mul(a, b)):
        raise AssertionError(f"{name}: two runs of the kernel differ")
    got, ra, rb = got.reshape(B, k), rows(a), b.reshape(B, k)
    max_abs_err, max_err_over_limit = 0.0, 0.0
    for c in chunks:
        want = ref.poly_mul_ref(ra[c], rb[c], torch.float64)
        tol = POLY_RTOL * ref.poly_mul_ref(ra[c].abs(), rb[c].abs(), torch.float64) + 1e-6
        if dtype == torch.bfloat16:
            tol += BF16_ULP * want.abs()
        err = (got[c].double() - want).abs()
        if bool((err > tol).any()):
            raise AssertionError(f"{name}: products outside tolerance (max |err| "
                                 f"{float(err.max())})")
        max_abs_err = max(max_abs_err, float(err.max()))
        max_err_over_limit = max(max_err_over_limit, float((err / tol).max()))
    del got, want, tol, err, ra, rb

    kernel_ms = cuda_ms(lambda: ops.poly_mul(a, b))
    plain_ms = cuda_ms(lambda: [ref.poly_mul_ref(rows(a)[c], b.reshape(B, k)[c], torch.float64)
                                for c in chunks], max_reps=3)
    # yardstick only: the torch.fft route (rfft, rfft, product, irfft) in
    # float32, which the port never calls on the card
    library_ms = cuda_ms(lambda: ref.poly_mul_ref(a, b))
    size = a.element_size()
    nbytes = (a.numel() + 2 * B * k) * size    # a and b read once, out written once
    flops = ops.operations(B, k)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / F32_OPS_PER_S) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_OPS_PER_S else "operations"
    direct = 2.0 * B * k * k
    rec = {"case": name, "B": B, "k": k, "dtype": str(dtype).replace("torch.", ""),
           "bcast": bcast, "max_abs_err": max_abs_err,
           "max_err_over_limit": max_err_over_limit, "ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes": nbytes, "fft_flops": flops, "direct_flops": direct,
           "direct_tflops_per_s": direct / kernel_ms / 1e9}
    log(f"  {name:<22} B={B} k={k} {rec['dtype']:<8} kernel_ms {kernel_ms:.4f}  "
        f"plain_ms {plain_ms:.4f}  library_ms {library_ms:.4f}  bound_ms {bound_ms:.4f} "
        f"({bound_by})  direct-form {direct:.3e} flops = {rec['direct_tflops_per_s']:.2f} "
        f"TFLOP/s  max_abs_err {max_abs_err:.3e} ({max_err_over_limit:.3f} of the limit)")
    del a, b
    torch.cuda.empty_cache()
    return rec


def phase_polymul(ops, ref, dev="cuda"):
    cases = [
        ("pm256_f32", 4 << 20, 256, torch.float32),     # fit B's largest ⊗: K=4, n=2^20
        ("pm256_bf16", 4 << 20, 256, torch.bfloat16),
        ("pm1024_f32", 1 << 18, 1024, torch.float32),
        ("pm64_offtile_f32", (1 << 20) + 3, 64, torch.float32),
        ("pm250_offtile_f32", (4 << 20) + 3, 250, torch.float32),   # the direct form
    ]
    recs = [poly_case(ops, ref, *c, dev=dev) for c in cases]
    # fit B's broadcast form: a one-node level's (1, 2^20, 256) factor
    # against (4, 2^20, 256) messages
    recs.append(poly_case(ops, ref, "pm256_bcast_f32", 4 << 20, 256, torch.float32, dev=dev,
                          bcast=4))
    return recs


def wkv_case(ops, ref, name, B, S, H, hs, c, seed=0, dev="cuda"):
    """One rwkv6_chunk shape: the kernel's output and terminal state within
    WKV_RTOL · W of the plain version in float64 (W the output, or the
    state, of |r|, |k|, |v|, |u| with the same decays), both bit-equal on a
    second run, and timings.  Returns the shape's record."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hs), dtype=np.float32) for _ in range(3))
    logw = -rng.uniform(0.01, 2.0, (B, S, H, hs)).astype(np.float32)
    u = rng.standard_normal((H, hs), dtype=np.float32)
    args = [torch.from_numpy(x).to(dev) for x in (r, k, v, logw, u)]
    got, st = ops.rwkv6_chunk(*args, c, return_state=True)
    got2, st2 = ops.rwkv6_chunk(*args, c, return_state=True)
    if not (torch.equal(got, got2) and torch.equal(st, st2)):
        raise AssertionError(f"{name}: two runs of the kernel differ")
    del got2, st2
    want, want_st = ref.rwkv6_chunk_ref(*args, c, torch.float64, return_state=True)
    mag, mag_st = ref.rwkv6_chunk_ref(args[0].abs(), args[1].abs(), args[2].abs(), args[3],
                                      args[4].abs(), c, torch.float64, return_state=True)
    err, st_err = (got.double() - want).abs(), (st.double() - want_st).abs()
    if bool((err > WKV_RTOL * mag).any()) or bool((st_err > WKV_RTOL * mag_st).any()):
        raise AssertionError(f"{name}: WKV outside {WKV_RTOL}·W (max |err|/W "
                             f"{float((err / mag).max())}, state "
                             f"{float((st_err / mag_st).max())})")
    max_abs_err, max_rel_err = float(err.max()), float((err / mag).max())
    st_abs_err, st_rel_err = float(st_err.max()), float((st_err / mag_st).max())
    del got, st, want, want_st, mag, mag_st, err, st_err

    segs = ops.segments(B, H, S // c)
    kernel_ms = cuda_ms(lambda: ops.rwkv6_chunk(*args, c, return_state=True))
    # the same call in one walk (one segment), where the plan cuts the sequence
    one_walk_ms = (cuda_ms(lambda: ops._launch(args, c, 1, True)) if segs > 1
                   else kernel_ms)
    plain_ms = cuda_ms(lambda: ref.rwkv6_chunk_ref(*args, c, return_state=True), max_reps=3)
    # r, k, v, logw, u read once; the output and the state written once
    nbytes = 4 * (5 * B * S * H * hs + H * hs + B * H * hs * hs)
    flops = ops.operations(B, S, H, hs, c)
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_OPS_PER_S * 1e3
    rec = {"case": name, "B": B, "S": S, "H": H, "hs": hs, "chunk": c, "segments": segs,
           "max_abs_err": max_abs_err, "max_err_over_w": max_rel_err,
           "state_max_abs_err": st_abs_err, "state_max_err_over_w": st_rel_err,
           "ms": kernel_ms, "one_walk_ms": one_walk_ms,
           "plain_ms": plain_ms, "library_ms": None, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes": nbytes, "flops": flops}
    log(f"  {name:<22} B={B} S={S} H={H} hs={hs} c={c} segments {segs} kernel_ms "
        f"{kernel_ms:.4f} (one walk {one_walk_ms:.4f})  plain_ms {plain_ms:.4f}  bound_ms "
        f"{rec['bound_ms']:.4f} ({rec['bound_by']}; {flops:.3e} flops = {ops_ms:.4f} ms)  "
        f"max_abs_err {max_abs_err:.3e}  max err/W {max_rel_err:.3e}  state max_abs_err "
        f"{st_abs_err:.3e}  max err/W {st_rel_err:.3e}")
    del args
    torch.cuda.empty_cache()
    return rec


def phase_wkv(ops, ref, dev="cuda"):
    cases = [
        ("prefill_8x1024", 8, 1024, 32, 64, 16),        # phase 5's prefill
        ("long_1x4096", 1, 4096, 32, 64, 16),
        ("one_1x1024", 1, 1024, 32, 64, 16),            # one prompt of the prefill's length
        ("ref_test_hs32", 2, 64, 2, 32, 16),             # tests/test_kernels.py's off shapes
        ("ref_test_hs16_c8", 3, 48, 1, 16, 8),
        ("tp_prefill_8x1024", 8, 1024, 16, 64, 16),     # phase 20 (d): a tp rank's 16 heads
    ]
    return [wkv_case(ops, ref, *c, dev=dev) for c in cases]


def wkv_strong_decay(ops, ref, dev="cuda"):
    """rwkv6_chunk where its factored decays are largest: every (hs, c) at
    (1, 16·c, 2, hs), in one walk and in 4 segments, with log-decays that
    put each chunk's cumulative decay in [−59.2, −52.8].  Output and state
    within WKV_RTOL · W of the plain version in float64; returns the
    largest err/W of each."""
    worst = {"max_err_over_w": 0.0, "state_max_err_over_w": 0.0}
    for hs in (16, 32, 64):
        for c in (8, 16):
            rng = np.random.default_rng(hs + c)
            S = 16 * c
            r, k, v = (rng.standard_normal((1, S, 2, hs), dtype=np.float32) for _ in range(3))
            logw = (-rng.uniform(3.3, 3.7, (1, S, 2, hs)) * (16 / c)).astype(np.float32)
            u = rng.standard_normal((2, hs), dtype=np.float32)
            args = [torch.from_numpy(x).to(dev) for x in (r, k, v, logw, u)]
            want, want_st = ref.rwkv6_chunk_ref(*args, c, torch.float64, return_state=True)
            mag, mag_st = ref.rwkv6_chunk_ref(args[0].abs(), args[1].abs(), args[2].abs(),
                                              args[3], args[4].abs(), c, torch.float64,
                                              return_state=True)
            for segs in (1, 4):
                got, st = ops._launch(args, c, segs, True)
                e = float(((got.double() - want).abs() / mag).max())
                es = float(((st.double() - want_st).abs() / mag_st).max())
                log(f"  strong_decay hs={hs} c={c} segments {segs}  max err/W {e:.3e}  state "
                    f"max err/W {es:.3e}")
                if not (e <= WKV_RTOL and es <= WKV_RTOL):
                    raise AssertionError(f"strong decay hs {hs} c {c} segments {segs}: WKV "
                                         f"outside {WKV_RTOL}·W ({e}, state {es})")
                worst = {"max_err_over_w": max(worst["max_err_over_w"], e),
                         "state_max_err_over_w": max(worst["state_max_err_over_w"], es)}
    return worst


def wkv_bwd_case(ops, ref, name, B, S, H, hs, c, seed=0, dev="cuda", decay=(0.01, 2.0),
                 timed=True, mixed=False):
    """One shape of the WKV backward kernel: dr, dk, dv, dlogw and du within
    WKV_BWD_RTOL · ``ref.rwkv6_chunk_bwd_scale`` of the plain backward in
    float64, bit-equal on a second run, and timings.  With ``mixed`` every
    other chunk decays by 80-96 (5-6 a token at c 16), past the kernel's
    switch from factored to pairwise decays at −60.  Returns the shape's
    record, with the launch the card takes (``ops.bwd_info``)."""
    rng = np.random.default_rng(seed)
    r, k, v, do = (rng.standard_normal((B, S, H, hs), dtype=np.float32) for _ in range(4))
    logw = -rng.uniform(*decay, (B, S, H, hs)).astype(np.float32)
    if mixed:
        odd = (np.arange(S) // c) % 2 == 1
        logw[:, odd] = -rng.uniform(5.0, 6.0, (B, int(odd.sum()), H, hs)) * (16 / c)
    u = rng.standard_normal((H, hs), dtype=np.float32)
    args = [torch.from_numpy(x).to(dev) for x in (r, k, v, logw, u, do)]
    got = ops.rwkv6_chunk_bwd(*args, c)
    again = ops.rwkv6_chunk_bwd(*args, c)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name}: two runs of the backward kernel differ")
    del again
    want = ref.rwkv6_chunk_bwd_ref(*args, c, torch.float64)
    scale = ref.rwkv6_chunk_bwd_scale(*args, c)
    errs, over = {}, {}
    for key, g, w, sc in zip(("dr", "dk", "dv", "dlogw", "du"), got, want, scale):
        err = (g.double() - w).abs()
        errs[key] = float(err.max())
        over[key] = float((err / (WKV_BWD_RTOL * sc).clamp_min(1e-300)).max())
        if bool((err > WKV_BWD_RTOL * sc).any()):
            raise AssertionError(f"{name}: {key} outside {WKV_BWD_RTOL}·scale (max |err|/limit "
                                 f"{over[key]})")
    del got, want, scale
    info = ops.bwd_info(hs, c)
    rec = {"case": name, "B": B, "S": S, "H": H, "hs": hs, "chunk": c, "decay": list(decay),
           "mixed": mixed, "launch": {**info, "ctas": B * H * info["split"]},
           "max_abs_err": max(errs.values()), "max_abs_err_by_grad": errs,
           "max_err_over_limit": max(over.values()), "err_over_limit_by_grad": over}
    if timed:
        kernel_ms = cuda_ms(lambda: ops.rwkv6_chunk_bwd(*args, c))
        plain_ms = cuda_ms(lambda: ref.rwkv6_chunk_bwd_ref(*args, c), max_reps=3)
        # r, k, v, logw, do read once; dr, dk, dv, dlogw written once; u read, du written
        nbytes = 4 * (9 * B * S * H * hs + 2 * H * hs)
        flops = 2 * ops.operations(B, S, H, hs, c)
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_OPS_PER_S * 1e3
        rec.update(ms=kernel_ms, plain_ms=plain_ms, library_ms=None,
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   bytes=nbytes, flops=flops)
    log(f"  {name:<22} B={B} S={S} H={H} hs={hs} c={c} decay {decay[0]}-{decay[1]} a token"
        + (" (every other chunk 80-96)" if mixed else "")
        + f"  design {info['design']}, split {info['split']}, {B * H * info['split']} CTAs, "
        f"{info['smem_bytes']} shared bytes a CTA, {info['ctas_per_sm']} CTAs an SM"
        + (f"  kernel_ms {rec['ms']:.4f}  plain_ms {rec['plain_ms']:.4f}  bound_ms "
           f"{rec['bound_ms']:.4f} ({rec['bound_by']}; {rec['flops']:.3e} flops)" if timed else "")
        + f"  max_abs_err {rec['max_abs_err']:.3e}  max err/limit {rec['max_err_over_limit']:.3f} "
        f"({', '.join(f'{k} {v:.3f}' for k, v in over.items())})")
    del args
    torch.cuda.empty_cache()
    return rec


def phase_wkv_bwd(ops, ref, dev="cuda"):
    cases = [
        ("train_1x2048", 1, 2048, 32, 64, 16, {}),                     # phase 11's microbatch
        ("tp_train_1x2048", 1, 2048, 16, 64, 16, {}),       # phase 20 (d): a tp rank's 16 heads
        ("ref_test_hs32", 2, 64, 2, 32, 16, {}),
        ("ref_test_hs16_c8", 3, 48, 1, 16, 8, {}),
        ("strong_53_59", 1, 256, 2, 64, 16, {"decay": (3.3, 3.7), "timed": False}),
        ("strong_80_96", 1, 256, 2, 64, 16, {"decay": (5.0, 6.0), "timed": False}),
        ("strong_53_59_c8", 1, 128, 2, 32, 8, {"decay": (6.6, 7.4), "timed": False}),
        ("strong_80_96_c8", 1, 128, 2, 32, 8, {"decay": (10.0, 12.0), "timed": False}),
        ("mixed_1x2048", 1, 2048, 32, 64, 16, {"mixed": True, "timed": False}),
    ]
    return [wkv_bwd_case(ops, ref, *c[:6], dev=dev, **c[6]) for c in cases]


def attn_case(ops, ref, name, B, S, N, Kh, dh, causal, dtype, seed=0, dev="cuda", window=None,
              with_lse=False, Sk=None):
    """One flash_attention shape (with ``window``, a causal band of w
    keys; with ``Sk``, a non-causal call over Sk keys, K3's
    cross-attention): the kernel within ``ref.attention_limit`` of a dense
    softmax in float64, determinism, and timings; with ``with_lse`` the
    call timed is the training forward's, which also writes the
    log-sum-exp (its plain version ``plain_attention``; its bound counts
    the lse's bytes; the library call stays SDPA, which returns no lse).
    Returns the shape's record."""
    Sk = S if Sk is None else Sk
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, S, N, dh), dtype=np.float32)).to(dev, dtype)
    k, v = (torch.from_numpy(rng.standard_normal((B, Sk, Kh, dh), dtype=np.float32))
            .to(dev, dtype) for _ in range(2))
    got = ops.flash_attention_gqa(q, k, v, causal, window=window)
    if not torch.equal(got, ops.flash_attention_gqa(q, k, v, causal, window=window)):
        raise AssertionError(f"{name}: two runs of the kernel differ")
    want, lim = ref.attention_limit(q, k, v, causal, window)
    err = (got.double() - want).abs()
    vmax, max_abs_err = float(v.abs().max()), float(err.max())
    err_over_limit = float((err / lim).max())
    if not err_over_limit <= 1:
        raise AssertionError(f"{name}: attention outside its limit (max |err| / limit "
                             f"{err_over_limit}, max |err| {max_abs_err}, max|v| {vmax})")
    # against the plain version too: two roundings, each within the limit (a windowed row
    # gated, the others printed: the plain bf16 version rounds each kv block's P·V to bf16,
    # past the limit on peaked rows, phase 6)
    plain_over = float(((got.double() - ref.flash_attention_ref(q, k, v, causal, window).double())
                        .abs() / lim).max())
    if window is not None and not plain_over <= PLAIN_FACTOR:
        raise AssertionError(f"{name}: kernel and plain version {plain_over} limits apart, more "
                             f"than {PLAIN_FACTOR}")
    del got, want, lim, err
    # the log-sum-exp output of the training forward, against float64
    out_l, lse = ops.flash_attention_gqa(q, k, v, causal, return_lse=True, window=window)
    want_l = ref.attention_lse_dense(q, k, causal, window)
    lse_err = (lse.double() - want_l).abs()
    lse_over = float((lse_err / (LSE_ATOL + LSE_RTOL * want_l.abs())).max())
    if not (lse_over <= 1 and torch.equal(out_l, ops.flash_attention_gqa(q, k, v, causal,
                                                                          window=window))):
        raise AssertionError(f"{name}: lse outside {LSE_ATOL} + {LSE_RTOL}·|lse| (max |err| "
                             f"{float(lse_err.max())}), or its output differs without lse")
    lse_max_err = float(lse_err.max())
    del out_l, lse, want_l, lse_err

    kernel_ms = cuda_ms(lambda: ops.flash_attention_gqa(q, k, v, causal, return_lse=with_lse,
                                                        window=window))
    plain_ms = (cuda_ms(lambda: plain_attention(q, k, v, causal, True, window), max_reps=3)
                if with_lse else
                cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal, window), max_reps=3))
    # yardstick only: one PyTorch call computing the same function, which
    # the port never calls (a band as a boolean mask, True where a key is seen)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window is None:
        library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True))
    else:
        i = torch.arange(S, device=dev)
        seen = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
        library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=seen, enable_gqa=True))
        del seen, i
    size = q.element_size()
    nbytes = (2 * B * S * N + 2 * B * Sk * Kh) * dh * size  # q, k, v read once, out written once
    nbytes += 4 * B * N * S if with_lse else 0               # ... and the float32 lse
    pairs = ops.pairs(S, causal, window, Sk)
    flops = 4 * B * N * dh * pairs
    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    rec = {"case": name, "B": B, "S": S, "Sk": Sk, "N": N, "Kh": Kh, "dh": dh, "causal": causal,
           "window": window, "lse": with_lse, "pairs_per_head": pairs,
           "dtype": str(dtype).replace("torch.", ""), "max_abs_err": max_abs_err,
           "max_err_over_limit": err_over_limit, "max_abs_v": vmax,
           "max_diff_to_plain_over_limit": plain_over,
           "lse_max_abs_err": lse_max_err, "lse_err_over_limit": lse_over,
           "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes": nbytes, "flops": flops, "tflops_per_s": flops / kernel_ms / 1e9,
           "library_tflops_per_s": flops / library_ms / 1e9,
           "ms_over_library_ms": kernel_ms / library_ms}
    log(f"  {name:<22} B={B} S={S}{'' if Sk == S else f' Sk={Sk}'} N={N} Kh={Kh} dh={dh} "
        f"{'causal' if causal else 'full'}"
        f"{'' if window is None else f' window {window}'}{' with lse' if with_lse else ''} "
        f"{rec['dtype']:<8} kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.4f}  library_ms "
        f"{library_ms:.4f}  bound_ms {rec['bound_ms']:.4f} ({rec['bound_by']}; "
        f"{rec['tflops_per_s']:.1f} TFLOP/s, library {rec['library_tflops_per_s']:.1f}; "
        f"kernel/library {rec['ms_over_library_ms']:.3f})  max_abs_err {max_abs_err:.3e}  "
        f"max err/limit {err_over_limit:.3f} (to plain {plain_over:.3f})  lse max |err| "
        f"{lse_max_err:.3e} (err/limit {lse_over:.3f})")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return rec


SASS_OPS = ("HGMMA", "UTMALDG", "SYNCS")   # wgmma, TMA tile loads, mbarrier operations


def attention_sass(ops, lib) -> dict:
    """The design of the built flash_attention library, read from its SASS
    (``cuobjdump``): per bf16 kernel (dh, causal) the count of each of
    SASS_OPS, and its dynamic shared memory.  Fails if a bf16 kernel has no
    HGMMA or no UTMALDG."""
    from repro_torch.kernels import _build

    sass = subprocess.run([_build.cuobjdump(), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"flash_attention_bf16_kernelILi(\d+)ELb(\d)", line)
            kernel = (f"bf16 dh {m.group(1)} {'causal' if m.group(2) == '1' else 'full'}"
                      if m else None)
            if kernel:
                counts[kernel] = dict.fromkeys(SASS_OPS, 0)
                counts[kernel]["smem_bytes"] = ops.bf16_smem_bytes(int(m.group(1)))
            continue
        op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if kernel and op:
            for name in SASS_OPS:
                counts[kernel][name] += op.group(1).startswith(name)
    if len(counts) != 8:
        raise AssertionError(f"flash_attention: {len(counts)} bf16 kernels in the SASS, not 8")
    for kernel, c in counts.items():
        log(f"  flash_attention SASS {kernel}: " + ", ".join(f"{k} {v}" for k, v in c.items()))
        if not (c["HGMMA"] and c["UTMALDG"]):
            raise AssertionError(f"flash_attention {kernel}: no wgmma (HGMMA) or no TMA load "
                                 f"(UTMALDG) in its SASS")
    return counts


def phase_attn(ops, ref, dev="cuda"):
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("prefill_8x2048", 8, 2048, 32, 4, 64, True, bf16),     # phase 6's prefill
        ("prefill_8x2048_f32", 8, 2048, 32, 4, 64, True, f32),  # its float32 twin
        ("long_1x8192", 1, 8192, 32, 4, 64, True, bf16),
        ("heads_40x128", 2, 1024, 40, 8, 128, True, bf16),      # Qwen2.5-32B / Llama-3 heads
        ("granite_8x2048", 8, 2048, 32, 8, 128, True, bf16),    # phase 12's prefills
        ("qwen_1x2048", 1, 2048, 40, 8, 128, True, bf16),
        ("llama3_1x2048_g16", 1, 2048, 128, 8, 128, True, bf16),   # 16 query heads a K/V head
        ("encoder_2x512", 2, 512, 16, 16, 64, False, f32),
        ("ragged_3x1000", 3, 1000, 8, 2, 32, True, f32),        # S off the 64-row tile
        ("smoke_2x24", 2, 24, 8, 1, 16, True, f32),
        # Hymba-1.5B (phase 13): 2,048 tokens + 128 meta positions, G 5
        ("hymba_8x2176_w1024", 8, 2176, 25, 5, 64, True, bf16, 1024),
        ("hymba_8x2176_global", 8, 2176, 25, 5, 64, True, bf16, None),
        ("long_1x16384_w1024", 1, 16384, 25, 5, 64, True, bf16, 1024),
        ("long_1x16384_causal", 1, 16384, 25, 5, 64, True, bf16, None),
        ("hymba_1x2176_w1024_f32", 1, 2176, 25, 5, 64, True, f32, 1024),   # the twin's
        ("hymba_1x2176_w48_f32", 1, 2176, 25, 5, 64, True, f32, 48),
        # phase 14's training forward (with the lse) at Hymba's microbatch, 1 x 2,048 + 128
        ("hymba_train_1x2176_w1024_lse", 1, 2176, 25, 5, 64, True, bf16, 1024, True),
        ("hymba_train_1x2176_causal_lse", 1, 2176, 25, 5, 64, True, bf16, None, True),
        ("dbrx_1x2048", 1, 2048, 48, 8, 128, True, bf16),       # phase 15: DBRX's G 6
        # phase 16's training forward with the lse at DBRX's microbatch
        ("dbrx_train_1x2048_lse", 1, 2048, 48, 8, 128, True, bf16, None, True),
        # phases 17-18: seamless-M4T's encoder self-attention and cross-attention (K3)
        ("seamless_enc_8x1024", 8, 1024, 16, 16, 64, False, bf16),
        ("seamless_cross_8x512x2048", 8, 512, 16, 16, 64, False, bf16, None, False, 2048),
        ("cross_2x40x70_f32", 2, 40, 8, 2, 32, False, f32, None, False, 70),   # odd, both tiles
        ("llava_1x2048_g7", 1, 2048, 56, 8, 128, True, bf16),   # phase 19: LLaVA's G 7
        # phase 20 (d): a tp rank's 16 local heads of TinyLlama's 32 and their 2 K/V heads
        ("tp_train_1x2048_lse", 1, 2048, 16, 2, 64, True, bf16, None, True),  # a microbatch
        ("tp_prefill_8x2048", 8, 2048, 16, 2, 64, True, bf16),
        ("tp_twin_2x2048_f32_lse", 2, 2048, 16, 2, 64, True, f32, None, True),  # the f32 twin
        # phase 20 (d): a tp rank's 24 of DBRX's 48 heads and 4 of its 8 K/V heads
        ("tp_dbrx_prefill_1x2048", 1, 2048, 24, 4, 128, True, bf16),
        ("tp_dbrx_train_1x2048_lse", 1, 2048, 24, 4, 128, True, bf16, None, True),
        # phase 20 (d): a tp rank's 8 of seamless-M4T's 16 heads and 8 of its 16 K/V heads:
        # the encoder (full) and the decoder's self-attention (causal) at the prefill's 8 x
        # 1,024, the cross-attention over another length (K3), the training forward's
        ("tp_seamless_enc_8x1024", 8, 1024, 8, 8, 64, False, bf16),
        ("tp_seamless_dec_8x1024", 8, 1024, 8, 8, 64, True, bf16),
        ("tp_seamless_cross_8x512x2048", 8, 512, 8, 8, 64, False, bf16, None, False, 2048),
        ("tp_seamless_enc_train_1x1024_lse", 1, 1024, 8, 8, 64, False, bf16, None, True),
        ("tp_seamless_dec_train_1x1024_lse", 1, 1024, 8, 8, 64, True, bf16, None, True),
    ]
    recs = [attn_case(ops, ref, *c[:8], dev=dev, window=c[8] if len(c) > 8 else None,
                      with_lse=len(c) > 9 and c[9], Sk=c[10] if len(c) > 10 else None)
            for c in cases]
    band, full = (next(r for r in recs if r["case"] == n)
                  for n in ("long_1x16384_w1024", "long_1x16384_causal"))
    log(f"  band against causal at (1, 16384, 25, 5, 64): {band['ms']:.4f} / {full['ms']:.4f} ms "
        f"= {band['ms'] / full['ms']:.4f} of the time, for "
        f"{band['pairs_per_head'] / full['pairs_per_head']:.4f} of the key-query pairs")
    return recs


def sketch_case(ops, ref, name, n, k, seed=0, dev="cuda"):
    """One count_sketch shape: both forms (the TPU kernel's arrays, and the
    hashed form that the compressor runs) within SKETCH_ROUND · m_j · W_j
    of the float64 sum per bucket j (m_j terms, W_j = Σ|x_t| over them:
    the atomics add in no fixed order), the unsketch within 2⁻²³ · |value|
    of the plain version, and timings.  Returns the shape's record."""
    from repro_torch.core.sketch import Hash2

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, generator=gen, device=dev)
    h = Hash2.make(np.random.default_rng(seed), k)
    idx = torch.arange(n, device=dev)
    b64, signs = h.bucket(idx), h.sign(idx)
    del idx
    want = torch.zeros(k, dtype=torch.float64, device=dev).index_add_(0, b64,
                                                                       x.double() * signs)
    lim = SKETCH_ROUND * torch.bincount(b64, minlength=k).double() * torch.zeros(
        k, dtype=torch.float64, device=dev).index_add_(0, b64, x.double().abs())
    b32 = b64.int()
    del b64
    worst, outs = {}, {"hashed": ops.count_sketch_hashed(x, h),
                       "arrays": ops.count_sketch(x, b32, signs, k)}
    for form, got in outs.items():
        err = (got.double() - want).abs()
        if bool((err > lim).any()):
            raise AssertionError(f"{name}: {form} sketch outside {SKETCH_ROUND}·m_j·W_j "
                                 f"(max |err| {float(err.max())})")
        worst[form] = (float(err.max()), float((err / lim.clamp(min=1e-300)).max()))
    sk = outs["hashed"]
    del outs, got
    scale = k / n
    est, state = torch.empty_like(x), torch.empty_like(x)
    ops.unsketch(x, sk, h, scale, est=est, state=state)
    want_e = ref.unsketch_ref(sk, h, n, scale)
    un_err = max(float(((est - want_e).abs() > 2.0 ** -23 * want_e.abs()).sum()),
                 float(((state - (x - want_e)).abs() > 2.0 ** -23 * (x - want_e).abs()).sum()))
    if un_err:
        raise AssertionError(f"{name}: unsketch off the plain version at {int(un_err)} elements")
    un_max = float((est - want_e).abs().max())

    # the route the plan did not take, where there is one (phase 1 keeps its time)
    route = ops.plan(n, k)
    alt = (ops.Plan("slabs", slabs=max(1, k // ops.SLAB_BUCKETS)) if route.route == "bins"
           else ops.Plan("bins") if ops.BIN_BUCKETS < k <= ops.BINS_MAX_K else None)
    if alt is not None:
        err = (ops._hashed(x, h, alt).double() - want).abs()
        if bool((err > lim).any()):
            raise AssertionError(f"{name}: the {alt.route} route outside {SKETCH_ROUND}·m_j·W_j")
        del err
    del want, lim, want_e

    kernel_ms = cuda_ms(lambda: ops.count_sketch_hashed(x, h))
    alt_ms = cuda_ms(lambda: ops._hashed(x, h, alt)) if alt is not None else None
    arrays_ms = cuda_ms(lambda: ops.count_sketch(x, b32, signs, k))   # with its range check
    unsketch_ms = cuda_ms(lambda: ops.unsketch(x, sk, h, scale, est=est, state=state))
    plain_ms = cuda_ms(lambda: ref.count_sketch_op(x, h), max_reps=3)
    # yardsticks only: one PyTorch call each, with the buckets precomputed
    library_ms = cuda_ms(lambda: torch.zeros(k, device=dev).index_add_(0, b32, x * signs))
    un_library_ms = cuda_ms(lambda: torch.index_select(sk, 0, b32) * signs * scale)
    nbytes = 4 * n + 4 * k                     # x read once, the sketch written once
    un_bytes = 4 * 3 * n + 4 * k               # x and sk read, est and state written
    rec = {"case": name, "n": n, "k": k, "route": route.route, "slabs": route.slabs,
           "max_abs_err": worst["hashed"][0],
           "max_err_over_limit": worst["hashed"][1], "arrays_max_abs_err": worst["arrays"][0],
           "unsketch_max_abs_err": un_max, "ms": kernel_ms, "arrays_ms": arrays_ms,
           "alt_route": None if alt is None else alt.route, "alt_ms": alt_ms,
           "unsketch_ms": unsketch_ms, "unsketch_bound_ms": un_bytes / HBM_BYTES_PER_S * 1e3,
           "unsketch_library_ms": un_library_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "bytes": nbytes}
    alt_txt = "" if alt is None else f" ({alt.route} route {alt_ms:.4f})"
    log(f"  {name:<22} n={n} k={k} {route.route} kernel_ms {kernel_ms:.4f}{alt_txt}  arrays_ms "
        f"{arrays_ms:.4f}  plain_ms {plain_ms:.4f}  library_ms {library_ms:.4f}  bound_ms "
        f"{rec['bound_ms']:.4f}  unsketch_ms {unsketch_ms:.4f} (library {un_library_ms:.4f}, "
        f"bound {rec['unsketch_bound_ms']:.4f})  max_abs_err {worst['hashed'][0]:.3e} "
        f"(err/limit {worst['hashed'][1]:.3f})")
    del x, b32, signs, sk, est, state
    torch.cuda.empty_cache()
    return rec


def phase_sketch(ops, ref, dev="cuda"):
    cases = [
        ("ref_test_100_16", 100, 16),                     # tests/test_kernels.py's shapes
        ("ref_test_1000_64", 1000, 64),
        ("ref_test_5000_256", 5000, 256),
        ("ref_test_512_128", 512, 128),
        ("ln_f_leaf", 2_048, 1 << 9),                     # TinyLlama's ln_f
        ("norm_leaf", 45_056, 1 << 13),                   # TinyLlama's ln1, ln2 (22 × 2048)
        ("mlp_leaf", 253_755_392, 1 << 25),               # w_down, w_gate, w_up
        ("attn_q_o_leaf", 92_274_688, 1 << 24),           # wq, wo
        ("embed_leaf", 66_060_288, 1 << 23),              # embed.tok, embed.head
        ("attn_k_v_leaf", 11_534_336, 1 << 21),           # wk, wv (22 × 2048 × 256)
        # RWKV-6 1.6B's stacked leaves (phase 11(b)): 24 layers, d 2048, d_ff 7168
        ("rwkv_ck_cv_leaf", 352_321_536, 1 << 26),        # ck, cv: the slabs route, 8 slabs
        ("rwkv_embed_leaf", 134_217_728, 1 << 25),        # embed.tok, embed.head (65,536 × 2048)
        ("rwkv_mix_leaf", 100_663_296, 1 << 24),          # wr, wk, wv, wg, wo, cr
        ("rwkv_lora_leaf", 3_145_728, 1 << 19),           # wA, wB (24 × 2048 × 64)
        ("rwkv_mu_leaf", 245_760, 1 << 15),               # mu (24 × 5 × 2048)
        ("rwkv_mu_c_leaf", 98_304, 1 << 14),              # mu_c (24 × 2 × 2048)
        ("rwkv_vec_leaf", 49_152, 1 << 13),               # ln1, ln2, w0, u, ln_x (24 × 2048)
        # Hymba-1.5B's stacked leaves (phase 14): 32 layers, d 1600, d_ff 5504, 25 heads
        ("hymba_mlp_leaf", 281_804_800, 1 << 26),         # w_up, w_gate, w_down: slabs, 8 slabs
        ("hymba_q_o_x_leaf", 81_920_000, 1 << 24),        # attn wq, wo; ssm wx, wo
        ("hymba_embed_leaf", 51_609_600, 1 << 23),        # embed.tok, embed.head (32,256 × 1600)
        ("hymba_b_c_leaf", 20_480_000, 1 << 22),          # ssm wB, wC (32 × 1600 × 400)
        ("hymba_k_v_leaf", 16_384_000, 1 << 21),          # attn wk, wv (32 × 1600 × 320)
        ("hymba_dt_leaf", 1_280_000, 1 << 18),            # ssm wdt (32 × 1600 × 25)
        ("hymba_meta_conv_leaf", 204_800, 1 << 15),       # meta (128 × 1600); conv (32 × 4 × 1600)
        ("hymba_vec_leaf", 51_200, 1 << 13),              # ln1, ln2, bn_a, bn_s; ssm Dskip
        ("hymba_ln_f_leaf", 1_600, 1 << 8),               # ln_f
        ("hymba_decay_leaf", 800, 1 << 7),                # ssm dt_bias, A_log (32 × 25)
        # seamless-M4T-medium's stacked leaves (phase 18): 12 + 12 layers, d 1024, d_ff 4096
        ("seamless_embed_leaf", 262_668_288, 1 << 25),    # embed.tok, embed.head (256,512 × 1024)
        ("seamless_mlp_leaf", 50_331_648, 1 << 23),       # w_up, w_down, encoder and decoder
        ("seamless_attn_leaf", 12_582_912, 1 << 21),      # wq, wk, wv, wo; xattn's (12 × 1024²)
        ("seamless_norm_leaf", 12_288, 1 << 11),          # ln1, ln2, ln_x (12 × 1024)
        ("seamless_ln_f_leaf", 1_024, 1 << 8),            # ln_f, enc_ln_f
    ]
    return [sketch_case(ops, ref, *c, dev=dev) for c in cases]


# ------------------------------------------------------------------ phase 2 --
def oracle_sums(schema, trees, names):
    """The float64 oracle of grouped scoring, materialize_join +
    predict_rows + bincount: {table: (Σŷ, count, Σ|ŷ|) per row} for every
    table in ``names``."""
    from repro_torch.core import materialize_join, predict_rows

    J = materialize_join(schema)
    X = torch.stack([J[c].to(torch.float32) for (_, c) in schema.features], dim=1)
    preds = predict_rows(trees, X).double()
    out = {}
    for name in names:
        rows, n = J["__rows__" + name], schema.table(name).n_rows
        out[name] = (torch.bincount(rows, weights=preds, minlength=n),
                     torch.bincount(rows, minlength=n).double(),
                     torch.bincount(rows, weights=preds.abs(), minlength=n))
    return out


def oracle_check(schema, trees, scores, tag):
    """Counts exact and totals within 1e-4·Σ|ŷ| of the oracle
    (``oracle_sums``), for every grouping table in ``scores``."""
    worst = 0.0
    for name, (want_tot, want_cnt, mag) in oracle_sums(schema, trees, scores).items():
        tot, cnt = scores[name]
        if not torch.equal(cnt.double(), want_cnt):
            raise AssertionError(f"{tag}: counts grouped by {name} differ from the oracle")
        err = (tot.double() - want_tot).abs()
        if bool((err > 1e-4 * mag + 1e-6).any()):
            raise AssertionError(f"{tag}: totals grouped by {name} off by up to "
                                 f"{float(err.max())}")
        worst = max(worst, float((err / (mag + 1e-12)).max()))
    return worst


def phase_serve(ops, n_fact: int, dev="cuda", profile: bool = False):
    from repro_torch.core import QueryCounter
    from repro_torch.launch import serve_relational as sr
    from repro_torch.obs import get_registry
    from repro_torch.relational.generators import star_schema
    from repro_torch.serving import (ModelRegistry, RelationalScoringService,
                                     compile_ensemble, score_grouped, score_mean_rows)

    args = argparse.Namespace(trees=5, depth=3, requests=2000, concurrency=256,
                              max_batch=64, max_wait_ms=1.0, cache_size=4096, zipf=1.3)
    times = {}
    t0 = time.perf_counter()
    schema = star_schema(seed=0, n_fact=n_fact, n_dim=N_KEYS, device=dev)
    sync(dev)
    times["schema_s"] = time.perf_counter() - t0
    log(f"  schema: tables { {t.name: t.n_rows for t in schema.tables} } "
        f"built in {times['schema_s']:.2f}s")

    reg = get_registry()
    edges0 = reg.counter("sumprod.edges").value
    sync(dev)
    ops.reset_launches()                                   # main path starts here
    t0 = time.perf_counter()
    trees = sr.train(schema, args)
    sync(dev)
    times["train_s"] = time.perf_counter() - t0
    counter = QueryCounter()
    t0 = time.perf_counter()
    ens = compile_ensemble(schema, trees, counter=counter)
    sync(dev)
    times["compile_s"] = time.perf_counter() - t0
    scores = {}
    for t in schema.tables:
        t0 = time.perf_counter()
        scores[t.name] = score_grouped(ens, t.name)
        sync(dev)
        times[f"score_grouped_{t.name}_s"] = time.perf_counter() - t0
    registry = ModelRegistry()
    registry.publish(ens)
    service = RelationalScoringService(registry, schema.label_table,
                                       max_batch=args.max_batch,
                                       max_wait_ms=args.max_wait_ms,
                                       cache_size=args.cache_size)
    t0 = time.perf_counter()
    served = asyncio.run(sr.drive(service, schema.table(schema.label_table).n_rows,
                                  args.requests, args.concurrency, args.zipf, registry,
                                  schema, args, counter))
    sync(dev)
    times["serve_and_swap_s"] = time.perf_counter() - t0
    launches = ops.launches                                # main path ends here
    train_edges = reg.counter("sumprod.edges").value - edges0
    serve_edges = counter.count * (schema.n_tables - 1)
    emissions = train_edges + serve_edges
    log(f"  phase times: " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    log(f"  QueryCounter: training edges {train_edges}, serving passes {counter.count} "
        f"({serve_edges} edges); segment_sum launches {launches}")
    if not (launches > 0 and launches >= emissions):
        raise AssertionError(f"segment_sum launches {launches} do not cover the "
                             f"{emissions} message emissions of the main path")

    # correctness against the oracle, outside the counted run
    t0 = time.perf_counter()
    worst = oracle_check(schema, trees, scores, "serve")
    v2_ens = registry.get(served["swap_version"])[1]
    want = score_mean_rows(v2_ens, schema.label_table, served["swap_ids"]).cpu().numpy()
    np.testing.assert_allclose(np.asarray(served["swap_scores"]), want, rtol=1e-6, atol=1e-6)
    times["oracle_s"] = time.perf_counter() - t0
    log(f"  oracle: counts exact on every table, worst total error "
        f"{worst:.3e}·Σ|ŷ|; post-swap answers match v{served['swap_version']}")
    out = {"times": times, "launches": launches, "emissions": emissions,
           "train_edges": train_edges, "serve_passes": counter.count,
           "qps": served["qps"], "p50_ms": served["p50_ms"], "p99_ms": served["p99_ms"],
           "cache_hit_rate": served["cache_hit_rate"], "n_fact": n_fact}
    if profile:
        from repro_torch.core import BoostConfig, Booster
        booster = Booster(schema, BoostConfig(n_trees=1, depth=3, mode="sketch",
                                              ssr_mode="off"))
        out["profile"] = {
            "train_one_more_tree": profile_window(lambda: booster.boost(trees, 1)),
            "score_grouped_all_tables": profile_window(
                lambda: [score_grouped(ens, t.name) for t in schema.tables]),
        }
        for k, v in out["profile"].items():
            log(f"  profile {k}: wall {v['wall_ms']:.1f} ms, kernels busy "
                f"{v['device_busy_ms']:.1f} ms, idle share {v['idle_share']:.3f}; "
                f"top {v['top']}")
    return out, schema, trees, ens, scores


def kernel_kind(name: str, split=()) -> str:
    """The class of a CUDA kernel by its name: one of the ``split`` kernels
    (a name or a tuple of names), a library matrix product, an elementwise
    pass, a reduction, or other."""
    for sp in (split,) if isinstance(split, str) else split:
        if sp and sp in name:
            return sp
    if any(t in name for t in ("nvjet", "gemm", "xmma", "cutlass")):
        return "gemm"
    return next((t for t in ("elementwise", "reduce") if t in name), "other")


def profile_window(fn, split=(), annotated=()) -> dict:
    """Device busy and idle share of one call, from a torch.profiler trace:
    the union of the CUDA kernels' intervals over the host wall time of the
    call (the profiler's own host overhead counts as idle).  ``split``
    names a kernel, or a tuple of them: their summed time comes back as
    ``split_ms``; ``by_kind`` sums the kernels' time by ``kernel_kind``,
    except that a kernel launched inside a ``record_function`` range named
    in ``annotated`` counts under that name (matched through the launch's
    correlation id), and so does one launched between an empty range
    ``<name>.bwd_begin`` and the next ``<name>.bwd_end`` (the marks that
    ``models/ssm.py`` puts around its branch's backward)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    kern = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"],
                   e.get("args", {}).get("correlation"))
                  for e in events if e.get("cat") == "kernel")
    if not kern:
        raise AssertionError("profiler trace holds no CUDA kernel")
    notes = [e for e in events if e.get("cat") == "user_annotation"]
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
              for e in notes if e.get("name") in annotated]
    opened = {}
    for t, name in sorted((float(e["ts"]), e["name"]) for e in notes if ".bwd_" in e["name"]):
        base, edge = name.rsplit(".bwd_", 1)
        if base not in annotated:
            continue
        if edge == "begin":
            opened[base] = t
        elif base in opened:
            ranges.append((opened.pop(base), t, base))
    ranges.sort()
    starts = [r[0] for r in ranges]
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}

    def range_of(corr):
        t = launched.get(corr)
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        return ranges[i][2] if i >= 0 and t <= ranges[i][1] else None

    busy, end, by_name, by_kind = 0.0, -1.0, {}, {}
    for s, e, name, corr in kern:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e3
        kind = (ranges and range_of(corr)) or kernel_kind(name, split)
        by_kind[kind] = by_kind.get(kind, 0.0) + (e - s) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return {"wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
            "idle_share": max(0.0, 1.0 - busy / 1e3 / wall_ms), "kernels": len(kern),
            "top": [(n[:60], round(ms, 3)) for n, ms in top],
            "by_kind": {k: round(v, 3) for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])},
            "split_ms": sum(by_kind.get(sp, 0.0)
                            for sp in ((split,) if isinstance(split, str) else split) if sp)}


# ------------------------------------------------------------------ phase 3 --
def phase_paper(n_fact: int, dev="cuda"):
    from repro_torch.core import (BoostConfig, Booster, MaterializedBooster,
                                  materialize_join, predict_rows)
    from repro_torch.relational.generators import star_schema

    t0 = time.perf_counter()
    sch = star_schema(seed=0, n_fact=n_fact, n_dim=N_KEYS, device=dev)
    J = materialize_join(sch)
    X = torch.stack([J[c].to(torch.float32) for (_, c) in sch.features], dim=1)
    y = J[sch.label_column]
    cfg = BoostConfig(n_trees=3, depth=3, mode="exact")
    te, tre = Booster(sch, cfg).fit()
    t_exact = time.perf_counter() - t0
    t0 = time.perf_counter()
    ts, trs = Booster(sch, BoostConfig(n_trees=3, depth=3, mode="sketch", sketch_k=256)).fit()
    t_sketch = time.perf_counter() - t0
    t0 = time.perf_counter()
    tm = MaterializedBooster(X, y, cfg).fit()
    t_mat = time.perf_counter() - t0
    for a, b in zip(te, ts):
        if not torch.equal(a.feat, b.feat):
            raise AssertionError("paper: exact and sketched trees split on different features")
    errs = []
    for e, s in zip(tre.node_ssr, trs.node_ssr):
        np.testing.assert_allclose(s["fact"].cpu().numpy(), e["fact"].cpu().numpy(),
                                   rtol=2e-3, atol=1e-2)
        for tbl in e:
            if tbl != "fact":
                ee, ss = e[tbl].cpu().numpy(), s[tbl].cpu().numpy()
                m = ee > 1.0
                errs.append((np.abs(ss - ee) / ee)[m])
    mean_err = float(np.concatenate(errs).mean())
    if not mean_err < 0.2:
        raise AssertionError(f"paper: mean relative SSR error {mean_err} ≥ 0.2")
    diff = float((predict_rows(te, X) - predict_rows(tm, X)).abs().max())
    if not diff < 2e-2:
        raise AssertionError(f"paper: relational vs materialized predictions differ by {diff}")
    mse = float(torch.mean((y - predict_rows(te, X)) ** 2))
    log(f"  paper: exact fit {t_exact:.2f}s ({tre.queries} queries), sketched fit "
        f"{t_sketch:.2f}s ({trs.queries} queries), materialized fit {t_mat:.2f}s; "
        f"mean rel SSR err (dims) {mean_err:.4f}; max |rel − mat| {diff:.2e}; "
        f"MSE {mse:.4f} vs var(y) {float(torch.var(y)):.4f}")
    return {"exact_s": t_exact, "sketch_s": t_sketch, "materialized_s": t_mat,
            "queries_exact": tre.queries, "queries_sketch": trs.queries,
            "mean_rel_ssr_err": mean_err, "max_pred_diff": diff, "n_fact": n_fact}


# ------------------------------------------------------------------ phase 4 --
def coeff_products(cfg, schema, n_plans: int) -> int:
    """PolyCoeff ⊗ of one sketched fit with per-table SSR.  A level with M
    previous-tree leaves runs τ·(1 + M) sketched passes (trainer
    ``_table_stats``: the labeled sketch, then one per leaf; none while
    M = 0), and a pass ⊗-s each join-tree edge's message into its
    parent's factor once (sumprod ``node_factor``)."""
    total = 0
    for t in range(cfg.n_trees):
        M = t * 2 ** cfg.depth
        if M:
            total += cfg.depth * n_plans * (1 + M) * (schema.n_tables - 1)
    return total


def phase_coeff_hist(pops, sops, n_fact: int, dev="cuda"):
    from repro_torch.core import (BoostConfig, Booster, hist_scores, materialize_join,
                                  predict_rows)
    from repro_torch.core.tree import root_masks
    from repro_torch.relational.generators import star_schema

    t0 = time.perf_counter()
    sch = star_schema(seed=0, n_fact=n_fact, n_dim=N_KEYS, device=dev)
    sync(dev)
    times = {"schema_s": time.perf_counter() - t0}
    out = {"n_fact": n_fact, "times": times}

    # A: the frequency domain, the comparison
    cfg_a = BoostConfig(n_trees=3, depth=3, mode="sketch", sketch_k=256, ssr_mode="per_table",
                        sketch_domain="freq")
    t0 = time.perf_counter()
    ba = Booster(sch, cfg_a)
    ta, tra = ba.fit()
    sync(dev)
    times["fit_a_freq_s"] = time.perf_counter() - t0

    # B: the paper's coefficient domain; every ⊗ is the polymul kernel
    cfg_b = dataclasses.replace(cfg_a, sketch_domain="coeff")
    bb = Booster(sch, cfg_b, hashes=ba.hashes)
    sync(dev)
    pops.reset_launches()                                  # fit B's path starts here
    sops.reset_launches()
    t0 = time.perf_counter()
    tb, trb = bb.fit()
    sync(dev)
    times["fit_b_coeff_s"] = time.perf_counter() - t0
    pm_launches, ss_launches_b = pops.launches, sops.launches   # ... and ends here
    want_products = coeff_products(cfg_b, sch, len(bb.plans))
    if not (pm_launches > 0 and pm_launches == want_products):
        raise AssertionError(f"coeff fit: polymul launches {pm_launches} != the fit's "
                             f"{want_products} PolyCoeff products")
    for x, y in zip(ta, tb):
        if not (torch.equal(x.feat, y.feat) and torch.equal(x.thr, y.thr)):
            raise AssertionError("coeff fit: trees differ from the frequency-domain fit's")
    worst = 0.0
    for ea, eb in zip(tra.node_ssr, trb.node_ssr):
        for tn in ea:
            va, vb = ea[tn].double(), eb[tn].double()
            m = va > 1.0
            rel = ((vb - va).abs() / va)[m]
            if rel.numel():
                worst = max(worst, float(rel.max()))
    if not worst <= 1e-3:
        raise AssertionError(f"coeff fit: SSR off the frequency domain's by rtol {worst}")
    out.update(polymul_launches=pm_launches, coeff_products=want_products,
               segment_sum_launches_b=ss_launches_b,
               ssr_max_rel_diff=worst, queries_a=tra.queries, queries_b=trb.queries,
               edges_a=ba.counter.edges, edges_b=bb.counter.edges)
    log(f"  fit A (freq): {times['fit_a_freq_s']:.2f}s, {tra.queries} queries, "
        f"{ba.counter.edges} edges; fit B (coeff): {times['fit_b_coeff_s']:.2f}s, "
        f"{trb.queries} queries, {bb.counter.edges} edges; trees identical; SSR max rel "
        f"diff {worst:.3e}; polymul launches {pm_launches} = {want_products} ⊗")

    # C: histogram splits through the segment-⊕ kernel route
    cfg_c = BoostConfig(n_trees=3, depth=3, mode="sketch", ssr_mode="off", split_mode="hist",
                        hist_bins=256, hist_route="kernel")
    t0 = time.perf_counter()
    bc = Booster(sch, cfg_c)
    sync(dev)
    times["hist_plans_s"] = time.perf_counter() - t0
    sops.reset_launches()                                  # fit C's path starts here
    pops.reset_launches()
    t0 = time.perf_counter()
    tc, trc = bc.fit()
    sync(dev)
    times["fit_c_hist_s"] = time.perf_counter() - t0
    ss_launches = sops.launches                            # ... and ends here
    if pops.launches:
        raise AssertionError("hist fit: launched polymul without a coefficient sketch")
    hist_launches = ss_launches - bc.counter.edges         # the rest are message emissions
    want_hist = cfg_c.n_trees * cfg_c.depth * len(bc.plans)
    if not (hist_launches > 0 and hist_launches == want_hist):
        raise AssertionError(f"hist fit: {hist_launches} segment-⊕ launches on the histogram "
                             f"route, expected one per table and level ({want_hist})")
    J = materialize_join(sch)
    X = torch.stack([J[c].to(torch.float32) for (_, c) in sch.features], dim=1)
    y = J[sch.label_column].double()
    var = float(torch.var(y, unbiased=False))
    mse_e = float(torch.mean((y - predict_rows(ta, X).double()) ** 2))
    mse_h = float(torch.mean((y - predict_rows(tc, X).double()) ** 2))
    if not ((mse_h - mse_e) / var <= 0.05 and mse_h < 0.5 * var):
        raise AssertionError(f"hist fit: MSE {mse_h} against exact splits' {mse_e}, "
                             f"var(y) {var}")
    route_err = 0.0
    masks = {t.name: root_masks(sch, t.name) for t in sch.tables}     # the first level
    for tn, plan in bc.plans.items():
        c3 = bc.engine.grouped_c3(tn, masks)
        n, s_ = c3[..., 0], c3[..., 1]
        tot_n, tot_s = n.sum(1), s_.sum(1)
        kern = hist_scores(plan, n, s_, tot_n, tot_s, route="kernel")
        gath = hist_scores(plan, n, s_, tot_n, tot_s, route="gather")
        for x, g in zip(kern, gath):
            fin = torch.isfinite(g)
            if not (torch.equal(fin, torch.isfinite(x))
                    and torch.allclose(x[fin], g[fin], rtol=2e-4, atol=2e-4)):
                raise AssertionError(f"hist fit: kernel and gather routes differ on {tn}")
            if bool(fin.any()):
                route_err = max(route_err, float(((x - g).abs() / (g.abs() + 1.0))[fin].max()))
    out.update(hist_launches=hist_launches, segment_sum_launches=ss_launches,
               queries_c=trc.queries, edges_c=bc.counter.edges, mse_exact=mse_e,
               mse_hist=mse_h, var_y=var, hist_route_rel_err=route_err)
    log(f"  fit C (hist, kernel route): plans {times['hist_plans_s']:.2f}s, fit "
        f"{times['fit_c_hist_s']:.2f}s, {trc.queries} queries, {bc.counter.edges} edges; "
        f"segment_sum launches {ss_launches} ({hist_launches} on the histogram route); MSE "
        f"{mse_h:.4f} vs exact splits {mse_e:.4f}, var(y) {var:.4f}; kernel vs gather route "
        f"rel diff {route_err:.3e}")

    # device time of one more tree of B (the third, 16 previous leaves)
    if torch.device(dev).type == "cuda":
        prof = profile_window(lambda: bb.boost(tb[:2], 1), split="poly_mul")
        out["profile_fit_b_third_tree"] = prof
        log(f"  profile fit B, third tree: wall {prof['wall_ms']:.1f} ms, kernels busy "
            f"{prof['device_busy_ms']:.1f} ms (polymul {prof['split_ms']:.1f} ms, rest "
            f"{prof['device_busy_ms'] - prof['split_ms']:.1f} ms), idle share "
            f"{prof['idle_share']:.3f}; top {prof['top']}")
    return out, sch


# ------------------------------------------------------------------ phase 5 --
@contextlib.contextmanager
def swapped(module, name: str, plain):
    """``module.<name>`` (a kernel's wrapper) replaced by ``plain`` inside the block."""
    kernel = getattr(module, name)
    setattr(module, name, plain)
    try:
        yield
    finally:
        setattr(module, name, kernel)


def upcast(t):
    """LM parameters with every bfloat16 tensor in float32."""
    if isinstance(t, dict):
        return {k: upcast(v) for k, v in t.items()}
    if isinstance(t, list):
        return [upcast(v) for v in t]
    return t.float() if t.dtype == torch.bfloat16 else t


def layer_errors(model, params, tokens, module, name: str, plain, oracle, extra=None):
    """Per attention of one prefill (a layer's, or an encoder's and a
    decoder's cross-attention too): the largest |error| / limit of the
    kernel (``module.<name>``) and of ``plain``, against ``oracle`` (giving
    the float64 result and the per-element limit), all three on the q, k,
    v that the served model gives that attention (``extra``: the batch's
    front-end inputs)."""
    kernel = getattr(module, name)
    errs = []

    def checking(q, k, v, causal=True, window=None):
        out = kernel(q, k, v, causal, window=window)
        want, lim = oracle(q, k, v, causal, window)
        errs.append((float(((out.double() - want).abs() / lim).max()),
                     float(((plain(q, k, v, causal, window).double() - want).abs() / lim).max())))
        return out

    with swapped(module, name, checking):
        model.prefill(params, {"tokens": tokens, **(extra or {})})
    return errs


def f32_gates(m32, p32, tokens, plain, max_len, steps: int, extra=None):
    """Gates (b) and (c) in float32 on ``m32``: the kernel-served prefill
    against the plain-served one (``plain``: (module, name, function))
    within LM_F32_RTOL of the largest logit with the same greedy tokens,
    and greedy decode after prefill(S) against prefill(S + t) at t = 1 and
    t = ``steps``, each within LM_F32_RTOL of its largest logit (``extra``:
    the batch's front-end inputs, the same at every length).  Returns the
    kernel-served prefill's logits and the record."""
    V = m32.cfg.vocab
    maxdiff = lambda a, b: float((a - b).abs()[:, :V].max())
    top = lambda a: LM_F32_RTOL * float(a[:, :V].abs().max())
    extra = extra or {}
    l32, c = m32.prefill(p32, {"tokens": tokens, **extra}, max_len)
    with swapped(*plain):
        plain32, _ = m32.prefill(p32, {"tokens": tokens, **extra})
    diff_b, lim_b = maxdiff(l32, plain32), top(l32)
    same = torch.equal(l32.argmax(-1), plain32.argmax(-1))
    ids, nxt = [], torch.argmax(l32, -1)
    for step in range(steps):
        ids.append(nxt)
        dl, c = m32.decode_step(p32, c, nxt)
        if step == 0:
            first = dl
        nxt = torch.argmax(dl, -1)
    diffs, lims = {}, {}
    for t, d in {1: first, steps: dl}.items():
        lt, _ = m32.prefill(p32, {"tokens": torch.cat([tokens, torch.stack(ids[:t], 1)], 1),
                                  **extra})
        diffs[t], lims[t] = maxdiff(d, lt), top(lt)
    rec = {"layers": m32.cfg.n_layers, "batch": tokens.shape[0],
           "max_diff_kernel_vs_plain_f32": diff_b, "limit_b": lim_b, "same_greedy": same,
           "max_diff_decode_vs_prefill_f32_by_step": diffs, "limits_c": lims}
    log(f"  float32 twin ({m32.cfg.n_layers} layers, {tokens.shape[0]} x {tokens.shape[1]}): "
        f"kernel vs plain {diff_b:.3e} (limit {lim_b:.3e}, same greedy tokens {same}); decode "
        f"vs prefill(S + t) " + ", ".join(f"t = {t}: {diffs[t]:.3e} (limit {lims[t]:.3e})"
                                          for t in diffs))
    if not (diff_b <= lim_b and same and all(diffs[t] <= lims[t] for t in diffs)):
        raise AssertionError(f"lm ({m32.cfg.name}) float32 twin: kernel and plain disagree, or "
                             f"decode is off prefill(S + t): {rec}")
    return l32, rec


def phase_lm(wops, other_ops, cfg, plain, batch: int = 8, prompt: int = 1024,
             decode_tokens: int = 64, dev="cuda", profile: bool = False,
             max_len=None, check_last: bool = False, oracle=None, twin_cfg=None,
             annotated=(), inspect=None, stub: int = 0, want_launches=None):
    """LM serving (phases 5, 6, 12 and 13): prefill ``batch`` × ``prompt`` ids,
    greedy-decode ``decode_tokens``; the gates (a)–(d) of the module
    docstring.  ``wops``: the wrapper module of the kernel on the path;
    ``plain``: (module, name, plain function) to patch in for gate (b);
    ``max_len``: the prefill's cache room; ``check_last``: gate (c) also
    at the last decode step in float32; ``oracle``: the kernel's function
    in float64 with its per-element limit, which turns gate (b)'s bf16
    half into phase 6's (each layer's kernel output against it, and the
    two bf16 models' distances to the float32 twin).  ``twin_cfg``
    (phases 12 and 13, where the model's float32 copy would not fit beside
    it): the float32 twin is a model of that config (the model's, cut in
    depth) with weights of its own, served on the first prompt before the
    model is built; gate (b) in bf16 is then the oracle's alone, and gate
    (c) in bf16 holds decode against the kernel-served prefill(S + 1), the
    plain-served one's distance to it being the rounding noise.
    ``annotated``: ``record_function`` ranges whose kernels the prefill's
    profile counts as kinds of their own (``profile_window``).
    ``inspect(model, params, tokens)``: run on the float32 twin and, right
    after the counted run and before gates (b) and (c), on the model; it
    raises where the model's own state makes those gates meaningless (phase
    15: an MoE prefill that dropped tokens) and returns a record.
    ``stub``: the rows of a front end's input beside the ``prompt`` tokens
    (phase 17: an encoder's ``src_frames``, phase 19: ``patches`` before
    the tokens), (batch, stub, D) N(0, 0.02²) from the same rng, the same
    at every length.  ``want_launches``: the counts gate (d) holds a
    prefill to, {counter of ``wops``: launches} (default: ``launches``
    once a layer)."""
    from repro_torch.models import Model

    kname = wops.__name__.split(".")[-2]
    V = cfg.vocab
    maxdiff = lambda a, b: float((a - b).abs()[:, :V].max())
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, V, (batch, prompt))).to(dev)
    extra = {}
    if stub:
        key = "src_frames" if cfg.kind == "encdec" else "patches"
        extra[key] = torch.from_numpy((rng.standard_normal((batch, stub, cfg.d_model)) * 0.02)
                                      .astype(np.float32)).to(dev)
    first = {k: v[:1] for k, v in extra.items()}
    want_launches = want_launches or {"launches": cfg.n_layers}
    steps32 = decode_tokens if check_last else 1
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    twin = twin_seen = None
    if twin_cfg is not None:
        m32 = Model(twin_cfg, device=dev)
        with torch.inference_mode():
            p32 = m32.init(torch.Generator(device=dev).manual_seed(1))
            if inspect is not None:
                twin_seen = inspect(m32, p32, tokens[:1])
            twin = f32_gates(m32, p32, tokens[:1], plain, max_len, steps32, first)[1]
        del m32, p32
        gc.collect()
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()

    model = Model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    sync(dev)
    times = {"init_s": time.perf_counter() - t0}
    def count(t):
        if isinstance(t, dict):
            t = list(t.values())
        return sum(count(v) for v in t) if isinstance(t, list) else t.numel()

    n_params = count(params)

    def masked(logits) -> bool:
        pad = logits[:, V:]
        return bool(torch.isfinite(logits[:, :V]).all()) and bool((pad == -1e30).all())

    inputs = {"tokens": tokens, **extra}
    with torch.inference_mode():
        logits, cache = model.prefill(params, inputs, max_len)   # warm-up, not counted
        for _ in range(2):
            logits, cache = model.decode_step(params, cache, torch.argmax(logits, -1))
        sync(dev)

        for o in (wops, *other_ops):                                   # main path starts here
            o.reset_launches()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, inputs, max_len)
        sync(dev)
        times["prefill_s"] = time.perf_counter() - t0
        launches_prefill = wops.launches
        counts_prefill = {c: getattr(wops, c) for c in want_launches}
        toks = torch.argmax(logits, -1)
        seq, finite = [toks], torch.ones((), dtype=torch.bool, device=dev)
        c = cache
        t0 = time.perf_counter()
        for step in range(decode_tokens):
            dl, c = model.decode_step(params, c, toks)
            if step == 0:
                first_decode = dl
            finite &= torch.isfinite(dl[:, :V]).all() & (dl[:, V:] == -1e30).all()
            toks = torch.argmax(dl, -1)
            seq.append(toks)
        sync(dev)
        times["decode_s"] = time.perf_counter() - t0
        launches = wops.launches                                       # ... and ends here
        others = {o.__name__: o.launches for o in other_ops}
        del c, dl

        # (a) finite and masked
        if not (masked(logits) and bool(finite)):
            raise AssertionError(f"lm ({cfg.name}): prefill or decode logits not finite, or "
                                 f"padded ids unmasked")
        # (d) launches: one a layer per prefill (or ``want_launches``), none while decoding
        if not (counts_prefill == want_launches and launches == launches_prefill):
            raise AssertionError(f"lm ({cfg.name}): {kname} launched {counts_prefill} in the "
                                 f"prefill and {launches - launches_prefill} while decoding; "
                                 f"expected {want_launches} and 0")
        if any(others.values()):
            raise AssertionError(f"lm ({cfg.name}): kernels off the LM path launched: {others}")
        seen = None if inspect is None else inspect(model, params, tokens)

        # outside the counted run: (b) kernel against plain inside the model,
        # the plain version patched into the module in place of the kernel.
        # In float32 (f32_gates) within LM_F32_RTOL of the largest logit with
        # the same greedy tokens.  In bf16, without an oracle (phase 5), no
        # further apart than the served model is from its float32 twin (its
        # own rounding).  With one (phases 6 and 12: the two bf16 attentions
        # round at different places, so the two bf16 models are independent
        # samples of rounding noise), each layer's kernel output on the
        # model's own q, k, v within the oracle's per-element limit, and,
        # with the same-weight twin, the two bf16 models no further apart
        # than their two distances to it added.
        # (c) decode after prefill(S) against prefill(S + t).  bf16 at t = 1:
        # no further from a reference prefill(S + 1) than DECODE_NOISE times
        # another prefill(S + 1)'s distance from it, over the same logits in
        # this run (a cache or position fault moves the logits by O(1);
        # rounding does not): the f32 twin's and the bf16 model's, or (with
        # twin_cfg) the kernel-served and the plain-served bf16 model's.
        # The reference's band ratio is printed.  float32 in f32_gates.
        layer_err = (None if oracle is None else
                     layer_errors(model, params, tokens, *plain[:2], plain[2], oracle, extra))
        with swapped(*plain):
            plain_logits = model.prefill(params, inputs)[0]
        diff_b = maxdiff(logits, plain_logits)
        inputs_c = {**inputs, "tokens": torch.cat([tokens, seq[0][:, None]], 1)}
        longer = model.prefill(params, inputs_c)[0]
        if twin_cfg is None:                       # the same weights in float32
            m32 = Model(cfg.replace(dtype="float32"), device=dev)
            p32 = upcast(params)
            l32, twin = f32_gates(m32, p32, tokens, plain, max_len, steps32, extra)
            noise, noise_plain = maxdiff(logits, l32), maxdiff(plain_logits, l32)
            ref_c = m32.prefill(p32, inputs_c)[0]
            other_c, ref_name = longer, "the f32 twin's prefill(S + 1)"
            bf16_ok = diff_b <= (noise if oracle is None else noise + noise_plain)
            del m32, p32, l32
        else:
            noise = noise_plain = None
            with swapped(*plain):
                other_c = model.prefill(params, inputs_c)[0]
            ref_c, ref_name, bf16_ok = longer, "prefill(S + 1)", True
        if layer_err is not None:
            bf16_ok = bf16_ok and all(e <= 1 for e, _ in layer_err)
            log(f"  per layer, on the served bf16 model's own q, k, v: max |err| / limit "
                f"against the float64 oracle {max(e for e, _ in layer_err):.3f} for the "
                f"kernel, {max(e for _, e in layer_err):.3f} for the plain version")
        diff_c, noise_c = maxdiff(first_decode, ref_c), maxdiff(other_c, ref_c)
        ratio_c = diff_c / (DECODE_NOISE * noise_c) if noise_c else math.inf
        band_c = float(((first_decode[:, :V].float() - longer[:, :V].float()).abs()
                        / (LM_BAND["atol"] + LM_BAND["rtol"] * longer[:, :V].float().abs())).max())
        log(f"  max |Δlogit| bf16: kernel vs plain {kname} {diff_b:.4f}"
            + ("" if noise is None else f" (the two bf16 models vs the f32 twin: {noise:.4f}, "
                                        f"{noise_plain:.4f})")
            + f"; decode vs {ref_name} {diff_c:.4f} (limit {DECODE_NOISE} x "
            f"{'the bf16' if twin_cfg is None else 'the plain-served'} prefill(S + 1)'s "
            f"{noise_c:.4f}: {ratio_c:.4f} of it; the reference's band, atol "
            f"{LM_BAND['atol']}, rtol {LM_BAND['rtol']}, against the bf16 prefill(S + 1), not "
            f"gated: {band_c:.4f})")
        if not bf16_ok:
            raise AssertionError(f"lm ({cfg.name}): kernel and plain {kname} disagree inside the "
                                 f"bf16 model")
        if not ratio_c <= 1:
            raise AssertionError(f"lm ({cfg.name}): decode after prefill(S) is off {ref_name} "
                                 f"by {diff_c:.4f}, limit {DECODE_NOISE * noise_c:.4f}")
        del plain_logits, longer, ref_c, other_c

        prefill_ms = cuda_ms(lambda: model.prefill(params, inputs, max_len), max_reps=5)
        prof = profile_window(lambda: model.prefill(params, inputs, max_len),
                              split=kname, annotated=annotated) \
            if torch.device(dev).type == "cuda" else None
        decode_prof = None
        if profile:
            def steps(n=16):
                lg, c = logits, cache
                for _ in range(n):
                    lg, c = model.decode_step(params, c, torch.argmax(lg, -1))
            decode_prof = profile_window(steps)

    seqs = torch.stack(seq, 1).cpu().numpy()
    decode_ms = times["decode_s"] * 1e3 / decode_tokens
    out = {"arch": cfg.name, "n_params": n_params, "layers": cfg.n_layers, "batch": batch,
           "prompt": prompt, "stub_rows": stub, "decode_tokens": decode_tokens, "times": times,
           "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
           "decode_tok_per_s": batch * decode_tokens / times["decode_s"],
           "launches": launches, "launches_prefill": launches_prefill,
           "counts_prefill": counts_prefill,
           "launches_decode": launches - launches_prefill,
           "max_diff_kernel_vs_plain": diff_b, "max_diff_bf16_vs_f32": noise,
           "max_diff_plain_bf16_vs_f32": noise_plain, "layer_err_over_limit": layer_err,
           "max_diff_decode_vs_prefill_ref": diff_c, "max_diff_prefill_vs_ref": noise_c,
           "decode_vs_noise_ratio": ratio_c, "decode_vs_prefill_band_ratio": band_c,
           "twin_f32": twin, "inspect": seen, "inspect_twin_f32": twin_seen,
           "sample": seqs[0, :16].tolist(),
           "peak_memory_bytes": (torch.cuda.max_memory_allocated()
                                 if torch.device(dev).type == "cuda" else None)}
    log(f"  {cfg.name}: {n_params:,} parameters ({cfg.n_layers} layers, d {cfg.d_model}), "
        f"init {times['init_s']:.2f}s")
    log(f"  prefill {batch}x{prompt}: {times['prefill_s'] * 1e3:.1f} ms (counted run), "
        f"{prefill_ms:.1f} ms (mean, CUDA events); decode {decode_tokens} tokens: "
        f"{decode_ms:.2f} ms a token, {out['decode_tok_per_s']:.1f} tok/s")
    log(f"  {kname} launches {launches_prefill} in the prefill, "
        f"{launches - launches_prefill} while decoding; greedy row 0 {out['sample']}")
    if prof is not None:
        out["profile_prefill"] = prof
        out["kernel_share_of_prefill"] = prof["split_ms"] / prof["device_busy_ms"]
        for name in annotated:
            out[f"{name}_share_of_prefill"] = (prof["by_kind"].get(name, 0.0)
                                               / prof["device_busy_ms"])
        log(f"  profile prefill: wall {prof['wall_ms']:.1f} ms, kernels busy "
            f"{prof['device_busy_ms']:.1f} ms ({kname} {prof['split_ms']:.1f} ms, share "
            f"{out['kernel_share_of_prefill']:.3f}"
            + "".join(f", {n} share {out[f'{n}_share_of_prefill']:.3f}" for n in annotated)
            + f"), idle share {prof['idle_share']:.3f}; "
            f"by kind {prof['by_kind']}; top {prof['top']}; peak memory "
            f"{out['peak_memory_bytes'] / 2 ** 30:.2f} GiB")
    if decode_prof is not None:
        out["profile_decode_16"] = decode_prof
        log(f"  profile 16 decode steps: wall {decode_prof['wall_ms']:.1f} ms, kernels busy "
            f"{decode_prof['device_busy_ms']:.1f} ms ({decode_prof['kernels']} kernels), idle "
            f"share {decode_prof['idle_share']:.3f}; by kind {decode_prof['by_kind']}; top "
            f"{decode_prof['top']}")
    return out


# ------------------------------------------------------------------ phase 7 --
TRAIN_KERNELS = ("flash_attention", "count_sketch_", "unsketch_kernel")


def plain_attention(q, k, v, causal, return_lse, window=None):
    """The training forward's plain version: the model's blockwise attention
    at the config's chunks, with the layer's window and its log-sum-exp as
    the kernel gives them."""
    from repro_torch.kernels.flash_attention.ref import KV_CHUNK, Q_CHUNK, block_attn_fwd

    B, S, N, _ = q.shape
    pos = lambda n: torch.arange(n, dtype=torch.int32, device=q.device).expand(B, n)
    out, lse = block_attn_fwd(q, k, v, pos(S), pos(k.shape[1]), causal, window, Q_CHUNK,
                              KV_CHUNK)
    return out.to(q.dtype), lse.reshape(B, N, S)


def plain_unsketch(x, sk, h, scale=1.0, est=None, state=None):
    """The compressor's unsketch by the plain version (``ref.unsketch_ref``)."""
    from repro_torch.kernels.count_sketch.ref import unsketch_ref

    e = unsketch_ref(sk, h, x.shape[0], scale)
    if state is not None:
        state.copy_(x - e)
    return e if est is None else est.copy_(e)


def train_twin(arch, swap, counted, want, dev="cuda", n_layers=4, batch=2, seq=2048,
               n_micro=2, **cut):
    """One float32 train step of ``arch`` at full width cut to ``n_layers``
    layers (and ``cut``, e.g. an encoder's ``enc_layers``), served by the
    kernels and then by the plain versions (the same weights, batch and
    hashes): ``swap`` is the (module, name, plain) of the model's kernel
    entry, the compressor's two passes are swapped too; ``counted`` the
    wrappers' counters that the kernel-served step must bump, ``want``
    those counts.  An encoder–decoder's batch holds ``seq``/2 frames and
    ``seq``/2 tokens a row (``launch/train.make_batch_for``'s split).
    Returns the comparison's record; raises outside its limits (module
    docstring, phases 7 and 11)."""
    from repro_torch import configs
    from repro_torch.kernels.count_sketch import ref as cref
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model, stack_layers
    from repro_torch.optim import CountSketchCompressor, adamw, grad_compress
    from repro_torch.tree import leaves, map_tree, paths

    cfg = configs.get(arch).replace(dtype="float32", n_layers=n_layers, **cut)
    model = Model(cfg, device=dev)
    base = stack_layers(model.init(torch.Generator(device=dev).manual_seed(0)))
    rng = np.random.default_rng(7)
    inputs = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq)))}
    if cfg.kind == "encdec":
        inputs = {"tokens": inputs["tokens"][:, :seq // 2], "src_frames": torch.from_numpy(
            (rng.standard_normal((batch, seq // 2, cfg.d_model)) * 0.02).astype(np.float32))}
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=5)
    counts = lambda: tuple(getattr(o, name) for o, name in counted)

    def run():
        params = map_tree(torch.clone, base)
        comp, rec = CountSketchCompressor(ratio=8), []

        def compress(g):
            comp(g)
            rec.extend(t.clone() for t in leaves(g))
        step = make_train_step(model, ocfg, n_micro, compressor=compress)
        for o, _ in counted:
            o.reset_launches()
        _, _, m = step(params, adamw.init(ocfg, params), {k: v.to(dev) for k, v in inputs.items()})
        sync(dev)
        return float(m["loss"]), rec, params, counts()

    loss_k, g_k, p_k, launches_k = run()
    with swapped(*swap), \
            swapped(grad_compress, "count_sketch_hashed", cref.count_sketch_op), \
            swapped(grad_compress, "unsketch", plain_unsketch):
        loss_p, g_p, p_p, launches_p = run()

    if not (launches_k == tuple(want) and not any(launches_p)):
        raise AssertionError(f"train twin: launches {launches_k} (kernels) and {launches_p} "
                             f"(plain); expected {tuple(want)} and none")
    rec = {"arch": cfg.name, "layers": n_layers, **cut, "batch": batch, "seq": seq,
           "n_micro": n_micro, "loss_kernel": loss_k, "loss_plain": loss_p,
           "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p), "leaves": {}}
    ok = rec["loss_rel_diff"] <= TRAIN_LOSS_RTOL and math.isfinite(loss_k)
    for name, gk, gp, pk, pp, p0 in zip(paths(base), g_k, g_p, leaves(p_k), leaves(p_p),
                                        leaves(base)):
        g_rel = float((gk - gp).abs().max() / gp.abs().max())
        dk, dp = pk.double() - p0.double(), pp.double() - p0.double()
        scale = float(dp.abs().max())
        d = dk - dp
        rec["leaves"][name] = {
            "grad_rel": g_rel, "step_rel": float(d.abs().max()) / scale,
            "frac_over": float((d.abs() > TRAIN_STEP_RTOL * scale).double().mean())}
        ok &= g_rel <= TRAIN_GRAD_RTOL
    log(f"  float32 twin ({cfg.name}, {n_layers} layers, {batch} x {seq}, n_micro {n_micro}): "
        f"loss kernel {loss_k:.7f} plain {loss_p:.7f} (rel {rec['loss_rel_diff']:.2e}); per leaf "
        f"max |Δg|/max|g| {max(v['grad_rel'] for v in rec['leaves'].values()):.2e}, max "
        f"|ΔΔp|/max|Δp| {max(v['step_rel'] for v in rec['leaves'].values()):.2e}, share of "
        f"elements over {TRAIN_STEP_RTOL}·max|Δp| "
        f"{max(v['frac_over'] for v in rec['leaves'].values()):.2e} (printed, not gated); "
        f"launches {launches_k}")
    if not ok:
        raise AssertionError(f"train twin: kernel- and plain-served steps disagree: {rec}")
    return rec


def train_smoke_checkpoint(dev="cuda"):
    """``launch/train.py``'s ``main`` at the smoke size on the card: 3 steps
    with a checkpoint, the checkpoint restored bit for bit, then a resumed
    fourth step."""
    import tempfile

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch import train as T
    from repro_torch.tree import leaves

    with tempfile.TemporaryDirectory() as d:
        flags = ["--device", dev, "--compress-grads", "8", "--log-every", "1", "--ckpt-dir", d]
        params = T.main(["--steps", "3", *flags])
        like = T.build(T.parser().parse_args(["--steps", "3", *flags]))
        like.pipe.stop()
        got = Checkpointer(d).restore(3, like.state())   # params, OptState, compressor state
        if not all(torch.equal(a, b) for a, b in zip(leaves(got[0]), leaves(params))):
            raise AssertionError("smoke train: checkpoint does not restore bit for bit")
        if int(got[2]["round"]) != 3:
            raise AssertionError("smoke train: the checkpoint holds compressor round "
                                 f"{int(got[2]['round'])}, not 3")
        T.main(["--steps", "4", "--resume", *flags])
        if Checkpointer(d).latest_step() != 4:
            raise AssertionError("smoke train: the resumed run did not checkpoint step 4")
    log("  smoke size on the card: 3 steps through launch.train.main, checkpoint restored bit "
        "for bit, resumed for step 4")


def run_steps(tr, n_micro: int, steps: int, counted, read, dev="cuda", profile=False,
              split=(), annotated=()):
    """An untimed warm-up step on the trainer's next batch, then ``steps``
    timed steps of ``launch/steps.make_train_step`` with the compressor
    (where the trainer has one) timed by CUDA events around its call; ``counted`` (wrapper modules) are
    set to 0 after the warm-up and ``read()`` is taken right after the last
    step.  With ``profile``, one more step traced (split by ``split``, the
    ``record_function`` ranges ``annotated`` as kinds of their own).
    Stops the trainer's pipeline."""
    from repro_torch.launch import steps as S

    events = []

    def timed(g):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        tr.compressor(g)
        ev[1].record()
        events.append(ev)
        return g

    step_fn = S.make_train_step(tr.model, tr.ocfg, n_micro,
                                compressor=None if tr.compressor is None else timed)
    params, state = tr.params, tr.opt_state
    out = {}
    try:
        t0 = time.perf_counter()
        out["warm_batch"] = tr.next_batch()
        params, state, m = step_fn(params, state, out["warm_batch"])          # warm-up
        sync(dev)
        out["warm_s"], out["warm_loss"] = time.perf_counter() - t0, float(m["loss"])
        events.clear()
        torch.cuda.reset_peak_memory_stats()
        for o in counted:                                                    # main path starts here
            o.reset_launches()
        step_s, losses, norms = [], [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            params, state, m = step_fn(params, state, tr.next_batch())
            sync(dev)
            step_s.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out["counts"] = read()                                               # ... and ends here
        out["peak"] = torch.cuda.max_memory_allocated()
        out["peak_reserved"] = torch.cuda.max_memory_reserved()   # the caching allocator's too
        out["comp_ms"] = [a.elapsed_time(b) for a, b in events]
        out["prof"] = profile_window(lambda: step_fn(params, state, tr.next_batch()),
                                     split=split, annotated=annotated) if profile else None
    finally:
        tr.pipe.stop()
    out.update(step_s=step_s, losses=losses, norms=norms, params=params)
    return out


def phase_train(fops, cops, other_ops, steps: int = 4, batch: int = 8, seq: int = 2048,
                n_micro: int = 8, dev="cuda", profile: bool = False):
    """TinyLlama-1.1B training at full width (phase 7 of the module
    docstring) through ``launch/train.py``'s ``build`` (model, stacked
    params, AdamW state, pipeline) and ``launch/steps.make_train_step``,
    the compressor timed by CUDA events around its call."""
    from repro_torch.launch import train as T

    args = T.parser().parse_args(["--full", "--steps", str(steps + 1), "--batch", str(batch),
                                  "--seq", str(seq), "--n-micro", str(n_micro),
                                  "--compress-grads", "8", "--ckpt-every", "0", "--device", dev])
    t0 = time.perf_counter()
    tr = T.build(args)
    sync(dev)
    init_s = time.perf_counter() - t0
    cfg = tr.model.cfg
    run = run_steps(tr, n_micro, steps, (fops, cops, *other_ops), lambda: (
        {"flash_attention": fops.launches, "count_sketch": cops.launches,
         "count_sketch_unsketch": cops.unsketch_launches},
        {o.__name__: o.launches for o in other_ops}), dev, profile, TRAIN_KERNELS)
    launches, others = run["counts"]
    step_s, losses, norms, warm_loss = run["step_s"], run["losses"], run["norms"], run["warm_loss"]
    peak, peak_reserved, comp_ms, prof = (run["peak"], run["peak_reserved"], run["comp_ms"],
                                          run["prof"])
    want = {"flash_attention": 2 * cfg.n_layers * n_micro * steps, "count_sketch": 12 * steps,
            "count_sketch_unsketch": 12 * steps}
    if not all(math.isfinite(x) for x in losses + [warm_loss]):
        raise AssertionError(f"train: a loss is not finite: {warm_loss}, {losses}")
    if launches != want or any(others.values()):
        raise AssertionError(f"train: launches {launches}, expected {want}; off the path {others}")
    tokens = batch * seq
    mean_s = sum(step_s) / len(step_s)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "batch": batch, "seq": seq,
           "n_micro": n_micro, "steps": steps, "compress_ratio": 8, "remat": cfg.remat,
           "init_s": init_s, "warmup_step_s": run["warm_s"], "step_s": step_s,
           "step_ms_mean": mean_s * 1e3, "tokens_per_s": tokens / mean_s,
           "loss_warmup": warm_loss, "losses": losses, "grad_norms": norms,
           "compressor_ms": comp_ms, "peak_memory_bytes": peak,
           "peak_reserved_bytes": peak_reserved,
           "launches": launches, "launches_per_step": {k: v / steps for k, v in launches.items()},
           "compressed_bytes": tr.compressor.compressed_bytes(run["params"])}
    log(f"  {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, global batch {batch} x {seq}, "
        f"n_micro {n_micro}, remat {cfg.remat}, compression 8; init {init_s:.2f}s, warm-up "
        f"step {run['warm_s']:.2f}s (loss {warm_loss:.4f})")
    log(f"  steps: {', '.join(f'{x * 1e3:.1f}' for x in step_s)} ms, mean {mean_s * 1e3:.1f} ms, "
        f"{out['tokens_per_s']:.0f} tokens/s; loss {', '.join(f'{x:.4f}' for x in losses)}; "
        f"grad norm {', '.join(f'{x:.3f}' for x in norms)}")
    log(f"  compressor {', '.join(f'{x:.2f}' for x in comp_ms)} ms a step (CUDA events); peak "
        f"memory {peak / 2 ** 30:.2f} GiB allocated, {peak_reserved / 2 ** 30:.2f} reserved; launches {launches} ({out['launches_per_step']} a "
        f"step); sketches {out['compressed_bytes'] / 1e6:.1f} MB a step")
    if prof is not None:
        out["profile_step"] = prof
        log(f"  profile one step: wall {prof['wall_ms']:.1f} ms, kernels busy "
            f"{prof['device_busy_ms']:.1f} ms, idle share {prof['idle_share']:.3f}; by kind "
            f"{prof['by_kind']}; top {prof['top']}")
    n_layers, n_micro_twin = 4, 2
    out["twin_f32"] = train_twin(
        "tinyllama_1_1b", (fops, "flash_attention_gqa", plain_attention),
        ((fops, "launches"), (cops, "launches")), (2 * n_layers * n_micro_twin, 12), dev,
        n_layers=n_layers, n_micro=n_micro_twin)
    train_smoke_checkpoint(dev)
    return out


# ------------------------------------------------------------------ phase 8 --
MAINTAIN_ROOTS = ("fact", "dim0")
MAINTAIN_BATCHES = 32
# relational/generators.delta_stream's batch mix: MIX_OPS ops a batch, each
# on a table drawn uniformly, an insert with p 0.35, a delete with p 0.3, else
# an update; at phase 2's scale each op moves a block of rows
MIX_OPS, MIX_P_INSERT, MIX_P_DELETE = 6, 0.35, 0.3
MAINTAIN_BLOCKS = {"fact": {"ins": 4096, "del": 1024, "upd": 1024},
                   "dim": {"ins": 4, "del": 4, "upd": 16}}


def pctl(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


class KeyMint:
    """Fresh join keys for the maintenance stream: ``new()`` mints past
    every key seen; fact rows take them first, and the dimension table
    inserts rows for them later (``pending``), so dangling fact rows
    come to join."""

    def __init__(self, schema):
        self.next = {c: int(schema.table(f"dim{i}").col(c).max()) + 1
                     for i, c in enumerate(("k0", "k1"))}
        self.pending = {c: [] for c in self.next}

    def new(self, col: str, n: int) -> np.ndarray:
        out = np.arange(self.next[col], self.next[col] + n, dtype=np.int64)
        self.next[col] += n
        return out


def draw_mix(rng, names) -> dict:
    """delta_stream's draw of one batch's ops: {table: {kind: ops}}."""
    mix = {n: {"ins": 0, "del": 0, "upd": 0} for n in names}
    for t, r in zip(rng.integers(len(names), size=MIX_OPS), rng.random(MIX_OPS)):
        kind = "ins" if r < MIX_P_INSERT else "del" if r < MIX_P_INSERT + MIX_P_DELETE else "upd"
        mix[names[t]][kind] += 1
    return mix


def maintain_batch(rng, ms, mint, blocks=MAINTAIN_BLOCKS, grow_rows=0):
    """One batch of phase 8(a) and its mix, drawn with vectorised numpy
    from the live slots: ``draw_mix``'s ops, each a block of rows
    (``blocks``).  Fact inserts take keys from the live dimension keys (1 %
    of them freshly minted); a dimension table's inserts take the keys the
    fact table minted, then fresh ones; deletes and updates hit distinct
    live rows; ``grow_rows`` more inserts into dim0."""
    from repro_torch.incremental import TableDelta

    mix = draw_mix(rng, ["fact", "dim0", "dim1"])
    mix["dim0"]["grow"] = grow_rows
    batch = []
    for name, ops in mix.items():
        dt = ms.tables[name]
        blk = blocks["fact" if name == "fact" else "dim"]
        n_ins = ops["ins"] * blk["ins"] + ops.get("grow", 0)
        n_del, n_upd = ops["del"] * blk["del"], ops["upd"] * blk["upd"]
        if not n_ins + n_del + n_upd:
            continue
        live = dt.live_slots()
        pick = live[rng.choice(len(live), n_del + n_upd, replace=False)]
        ins = None
        if n_ins and name == "fact":
            ins = {}
            for i, c in enumerate(("k0", "k1")):
                dim = ms.tables[f"dim{i}"]
                keys = dim.columns[c][dim.live_slots()][rng.integers(0, dim.n_live, n_ins)]
                fresh = rng.random(n_ins) < 0.01
                keys[fresh] = mint.new(c, int(fresh.sum()))
                mint.pending[c].extend(keys[fresh].tolist())
                ins[c] = keys.astype(dt.columns[c].dtype)
        elif n_ins:
            c = "k0" if name == "dim0" else "k1"
            owed, mint.pending[c] = mint.pending[c][:n_ins], mint.pending[c][n_ins:]
            ins = {c: np.concatenate([np.asarray(owed, np.int64),
                                      mint.new(c, n_ins - len(owed))]).astype(dt.columns[c].dtype)}
        feats = [f for f in dt.columns if f not in ("k0", "k1")]
        if ins is not None:
            ins.update({f: rng.standard_normal(n_ins).astype(dt.columns[f].dtype) for f in feats})
        upd_feats = [f for f in feats if f != "y"]
        batch.append(TableDelta(
            name, inserts=ins, deletes=pick[:n_del] if n_del else None,
            updates=(pick[n_del:], {f: rng.standard_normal(n_upd).astype(np.float32)
                                    for f in upd_feats}) if n_upd else None))
    return batch, mix


def audit_maintained(ms, roots, tag):
    """One effective schema (a pinned snapshot's), the recompute oracle
    of every root from it, bit-equal to the maintained scores."""
    t0 = time.perf_counter()
    snap = ms.snapshot(roots, pin_oracle=True)
    worst = 0.0
    for r in roots:
        for got, want in zip(ms.grouped_cached(r), snap.recompute_oracle(r)):
            worst = max(worst, float((got - want).abs().max()))
    if worst != 0.0:
        raise AssertionError(f"maintain: {tag} audit max|diff| {worst}, wants 0.0")
    return time.perf_counter() - t0


async def serve_maintained(ms, root, n_requests=2000, zipf=1.3):
    """Zipf row requests through the service over the published scorer;
    every answer must be grouped_cached's mean for its row."""
    from repro_torch.serving import ModelRegistry, RelationalScoringService

    registry = ModelRegistry()
    registry.publish(ms)
    svc = RelationalScoringService(registry, root, max_batch=64, max_wait_ms=1.0,
                                   cache_size=4096)
    n = ms.n_rows(root)
    ids = np.minimum(np.random.default_rng(2).zipf(zipf, n_requests) - 1, n - 1)
    await svc.start()
    t0 = time.perf_counter()
    got = []
    for chunk in np.array_split(ids, max(1, n_requests // 256)):
        got += await svc.score_many(chunk.tolist())
    dt = time.perf_counter() - t0
    await svc.stop()
    tot, cnt = ms.grouped_cached(root)
    want = (tot / torch.clamp(cnt, min=1.0))[torch.from_numpy(ids).to(tot.device)].cpu().numpy()
    bad = int(np.sum(np.asarray(got, np.float32) != want))
    if bad:
        raise AssertionError(f"maintain: {bad} of {n_requests} service answers differ from "
                             f"grouped_cached's means")
    snap = svc.stats_snapshot()
    return {"requests": n_requests, "qps": n_requests / dt, "p50_ms": snap["latency_ms"]["p50"],
            "p99_ms": snap["latency_ms"]["p99"], "cache_hit_rate": snap["cache_hit_rate"]}


def phase_maintain(ops, schema, trees, dev="cuda", profile=False, blocks=MAINTAIN_BLOCKS):
    """Phase 8(a): maintenance at phase 2's scale on phase 2's schema and
    trees (module docstring)."""
    import os
    import tempfile

    from repro_torch.core import QueryCounter
    from repro_torch.incremental import MaintainedScorer
    from repro_torch.incremental.recover import recover_scorer, save_checkpoint
    from repro_torch.incremental.wal import WalWriter, wal_path
    from repro_torch.serving import compile_ensemble

    roots, n_batches = MAINTAIN_ROOTS, MAINTAIN_BATCHES
    counter = QueryCounter()
    t0 = time.perf_counter()
    ms = MaintainedScorer(compile_ensemble(schema, trees), counter=counter)
    for r in roots:
        ms.grouped_cached(r)                              # the first, full passes
    sync(dev)
    setup_s = time.perf_counter() - t0
    full = sum(len(schema.join_tree(r).edges) for r in roots)
    csr_sides = len({(frozenset((e.child, e.parent)), e.child)      # the CSRs jt() keeps
                     for r in roots for e in schema.join_tree(r).edges})
    rng = np.random.default_rng(8)
    mint = KeyMint(schema)
    rec = {k: [] for k in ("apply_ms", "csr_ms", "csr_builds", "refresh_ms", "edges",
                           "launches", "mix")}
    out = {"n_fact": schema.table("fact").n_rows, "batches": n_batches, "roots": list(roots),
           "setup_s": setup_s, "full_pass_edges": full, "per_batch": rec}
    with tempfile.TemporaryDirectory() as tmp:
        wal_dir, ckpt_dir = os.path.join(tmp, "wal"), os.path.join(tmp, "ckpt")
        wal = WalWriter(wal_dir, sync_every=8).attach(ms.state)
        snap = pin = None
        for b in range(1, n_batches + 1):
            cap0 = ms.tables["dim0"].capacity
            batch, mix = maintain_batch(rng, ms, mint, blocks, grow_rows=2048 if b == 17 else 0)
            rec["mix"].append({t: {k: n for k, n in o.items() if n}       # tables it touched
                               for t, o in mix.items() if any(o.values())})
            t0 = time.perf_counter()
            ms.apply(batch)
            sync(dev)
            rec["apply_ms"].append((time.perf_counter() - t0) * 1e3)
            if b == 17 and not ms.tables["dim0"].capacity >= 2 * cap0:
                raise AssertionError(f"maintain: dim0 capacity {cap0} → "
                                     f"{ms.tables['dim0'].capacity}, expected it doubled")
            e0, csr0, builds0 = counter.edges, ms.state.csr_s, ms.state.csr_builds
            ops.reset_launches()                           # the refresh starts here
            t0 = time.perf_counter()
            for r in roots:
                ms.grouped_cached(r)
            sync(dev)
            rec["refresh_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["launches"].append(ops.launches)           # ... and ends here
            rec["edges"].append(counter.edges - e0)
            rec["csr_ms"].append((ms.state.csr_s - csr0) * 1e3)
            rec["csr_builds"].append(ms.state.csr_builds - builds0)
            log(f"  batch {b:>2}: apply {rec['apply_ms'][-1]:7.2f} ms, refresh "
                f"{rec['refresh_ms'][-1]:7.2f} ms (CSR {rec['csr_ms'][-1]:6.2f}, "
                f"{rec['csr_builds'][-1]} built), edges {rec['edges'][-1]}/{full}, segment_sum "
                f"launches {rec['launches'][-1]}; ops {rec['mix'][-1]}")
            if b in (16, n_batches):
                out[f"audit_{b}_s"] = audit_maintained(ms, roots, f"batch {b}")
            if b == 16:
                save_checkpoint(ms.state, ckpt_dir)
            if b == 19:                                    # pinned before batch 20
                snap = ms.snapshot(roots)
                pin = {r: [t.clone() for t in snap.grouped_cached(r)] for r in roots}
            if b == 24:
                for r in roots:
                    if not all(torch.equal(a, p) for a, p in zip(snap.score_grouped(r), pin[r])):
                        raise AssertionError(f"maintain: the snapshot of version 19 scores "
                                             f"{r} differently after batch 24")
                snap = pin = None
        wal.close()
        out["wal_bytes"] = os.path.getsize(wal_path(wal_dir))
        if rec["launches"] != rec["edges"] or not sum(rec["launches"]) > 0:
            raise AssertionError(f"maintain: refresh launches {rec['launches']} against the "
                                 f"counter's edges {rec['edges']}")
        out["service"] = asyncio.run(serve_maintained(ms, "fact"))
        t0 = time.perf_counter()
        ms2, rep = recover_scorer(compile_ensemble(schema, trees), wal_dir, ckpt_dir,
                                  counter=QueryCounter())
        for r in roots:
            if not all(torch.equal(a, b) for a, b in zip(ms2.grouped_cached(r),
                                                          ms.grouped_cached(r))):
                raise AssertionError(f"maintain: the recovered scorer differs on {r}")
        sync(dev)
        out["recovery_s"] = time.perf_counter() - t0
    if not (rep.recovered_lsn == ms2.data_version == n_batches and rep.checkpoint_lsn == 16):
        raise AssertionError(f"maintain: recovered {rep}, data_version {ms2.data_version}")
    if profile:                           # the recovered scorer takes one more batch
        batch, _ = maintain_batch(rng, ms2, mint, blocks)
        out["profile_apply"] = profile_window(lambda: ms2.apply(batch))
        out["profile_refresh"] = profile_window(lambda: [ms2.grouped_cached(r) for r in roots])
        for k in ("profile_apply", "profile_refresh"):
            v = out[k]
            log(f"  {k}: wall {v['wall_ms']:.1f} ms, kernels busy {v['device_busy_ms']:.1f} "
                f"ms, idle share {v['idle_share']:.3f}; by kind {v['by_kind']}")
    out.update(recovered_lsn=rep.recovered_lsn, replayed=rep.replayed,
               launches=sum(rec["launches"]), edges=sum(rec["edges"]),
               full_edges=full * n_batches, csr_builds=sum(rec["csr_builds"]),
               csr_builds_full=csr_sides * n_batches,
               refreshes_by_edges={e: rec["edges"].count(e) for e in sorted(set(rec["edges"]))},
               clean_tables=sum(len(ms.tables) - len(m) for m in rec["mix"]),
               capacities={t: dt.capacity for t, dt in ms.tables.items()})
    for k in ("apply_ms", "csr_ms", "refresh_ms"):
        out[k] = {"p50": pctl(rec[k], 50), "p99": pctl(rec[k], 99)}
    log(f"  maintain: setup {setup_s:.2f}s; over {n_batches} batches apply p50 "
        f"{out['apply_ms']['p50']:.2f} / p99 {out['apply_ms']['p99']:.2f} ms, refresh p50 "
        f"{out['refresh_ms']['p50']:.2f} / p99 {out['refresh_ms']['p99']:.2f} ms, CSR rebuild "
        f"p50 {out['csr_ms']['p50']:.2f} / p99 {out['csr_ms']['p99']:.2f} ms; edges "
        f"{out['edges']} of {out['full_edges']} full-pass (refreshes by edges "
        f"{out['refreshes_by_edges']}), CSRs built {out['csr_builds']} of "
        f"{out['csr_builds_full']}, {out['clean_tables']} of {len(ms.tables) * n_batches} "
        f"tables untouched by their batch, segment_sum launches {out['launches']}; audits "
        f"{out['audit_16_s']:.2f}s and {out[f'audit_{n_batches}_s']:.2f}s bit-equal; snapshot "
        f"of version 19 bit-equal after batch 24")
    log(f"  maintain: service {out['service']['requests']} Zipf(1.3) requests, "
        f"{out['service']['qps']:.0f} QPS, p50 {out['service']['p50_ms']:.2f} / p99 "
        f"{out['service']['p99_ms']:.2f} ms, every answer grouped_cached's; recovery "
        f"{out['recovery_s']:.2f}s (checkpoint 16 + {rep.replayed} replayed, WAL "
        f"{out['wal_bytes']} bytes) bit-equal to the live scorer")
    return out


def phase_retrain(ops, schema, n_batches=4, rows_per_batch=16384, dev="cuda", profile=False):
    """Phase 8(b): warm-start refits at phase 4's scale on phase 4's
    schema (module docstring)."""
    from repro_torch.core import BoostConfig, Booster
    from repro_torch.incremental import IncrementalBooster
    from repro_torch.relational.generators import drift_stream

    cfg = BoostConfig(n_trees=3, depth=3, mode="sketch", ssr_mode="off")
    t0 = time.perf_counter()
    ib = IncrementalBooster(schema, cfg)
    sync(dev)
    out = {"n_fact": schema.table("fact").n_rows, "setup_s": time.perf_counter() - t0,
           "refits": []}
    t0 = time.perf_counter()
    ib.fit()
    sync(dev)
    out["fit_s"] = time.perf_counter() - t0
    launches = 0
    for b, batch in enumerate(drift_stream(schema, ib.live_rows, seed=9, n_batches=n_batches,
                                           rows_per_batch=rows_per_batch)):
        frozen = list(ib.trees)
        sig0 = ib.engine.signature_s
        ops.reset_launches()                               # the refit starts here
        t0 = time.perf_counter()
        rep = ib.refit(deltas=batch, n_new_trees=1, drift_threshold=-math.inf)
        sync(dev)
        refit_s = time.perf_counter() - t0
        refit_launches = ops.launches                      # ... and ends here
        launches += refit_launches
        if refit_launches != rep.edges:
            raise AssertionError(f"retrain: refit {b} launched segment_sum {refit_launches} "
                                 f"times for {rep.edges} message emissions")
        t0 = time.perf_counter()                           # a scratch warm start:
        oracle = Booster(ib.effective_schema(), cfg, hashes=ib.booster.hashes)  # its schema,
        sync(dev)
        schema_s = time.perf_counter() - t0
        want, _ = oracle.boost(frozen, 1)                  # ... and its tree
        sync(dev)
        scratch_s = time.perf_counter() - t0
        got = ib.trees[-1]
        if not (torch.equal(got.feat, want[-1].feat)
                and torch.allclose(got.thr, want[-1].thr, rtol=1e-6, atol=1e-6)
                and torch.allclose(got.leaf, want[-1].leaf, rtol=1e-4, atol=1e-5)):
            raise AssertionError(f"retrain: refit {b} differs from the scratch warm start: "
                                 f"{got} against {want[-1]}")
        if not rep.edges < oracle.counter.edges:
            raise AssertionError(f"retrain: refit {b} emitted {rep.edges} edges, the scratch "
                                 f"warm start {oracle.counter.edges}")
        r = {"refit_s": refit_s, "scratch_s": scratch_s, "scratch_schema_s": schema_s,
             "edges": rep.edges,
             "scratch_edges": oracle.counter.edges, "edge_ratio": rep.edges / oracle.counter.edges,
             "signature_ms": (ib.engine.signature_s - sig0) * 1e3, "queries": rep.queries,
             "drift": rep.drift, "mse_after": rep.mse_after,
             "cache_hit_rate": rep.cache_hit_rate, "launches": refit_launches}
        out["refits"].append(r)
        log(f"  refit {b}: {refit_s:.2f}s against the scratch warm start's {scratch_s:.2f}s "
            f"(its schema and split plans {schema_s:.2f}s); "
            f"edges {rep.edges} / {oracle.counter.edges} = {r['edge_ratio']:.3f}; signatures "
            f"{r['signature_ms']:.1f} ms; segment_sum launches {refit_launches}; drift "
            f"{rep.drift:.3f}, mse {rep.mse_after:.4f}; trees match")
    if not launches > 0:
        raise AssertionError("retrain: no segment_sum launch in the refits")
    out["launches"] = launches
    if profile:                           # one more drift batch and refit
        batch = next(drift_stream(schema, ib.live_rows, seed=10, n_batches=1,
                                  rows_per_batch=rows_per_batch))
        v = out["profile_refit"] = profile_window(
            lambda: ib.refit(deltas=batch, n_new_trees=1, drift_threshold=-math.inf))
        log(f"  profile one more refit: wall {v['wall_ms']:.1f} ms, kernels busy "
            f"{v['device_busy_ms']:.1f} ms, idle share {v['idle_share']:.3f}; by kind "
            f"{v['by_kind']}")
    log(f"  retrain: setup {out['setup_s']:.2f}s, fit {out['fit_s']:.2f}s; {n_batches} refits, "
        f"segment_sum launches {launches}")
    return out


# ------------------------------------------------------------------ phase 9 --
OPERATED_SLO = "latency=50ms@0.99,errors=0.01,staleness=5s"
FLIGHT_RING = 4096
AB_VARIANTS = ((7, 0.5), (8, 0.25), (9, 0.125))   # (seed, shrinkage) of each A/B variant
FOLLOW_CHECKPOINT, FOLLOW_LAST = 8, 24            # writer checkpoints, then tails to here
FOLLOW_PERIOD_S = 0.05
ENDPOINTS = ("/metricsz", "/healthz", "/statusz", "/tracez")


def fetch(url: str, timeout: float = 10.0):
    """(HTTP status, body) of a GET; a 503 from /healthz is an answer."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def prom_value(text: str, name: str) -> float:
    m = re.search(rf"^{name} (\S+)$", text, re.M)
    if m is None:
        raise AssertionError(f"operate: {name} missing from /metricsz")
    return float(m.group(1))


def grouped_means(ens, root, ids) -> np.ndarray:
    tot, cnt = ens.grouped_cached(root)
    return (tot / torch.clamp(cnt, min=1.0))[torch.from_numpy(np.asarray(ids)).to(tot.device)
                                              ].cpu().numpy()


def serve_args(tmp, telemetry: bool):
    """``serve_relational``'s arguments for phase 2's traffic, every
    telemetry flag on or off."""
    import os

    args = argparse.Namespace(
        trees=5, depth=3, requests=2000, concurrency=256, max_batch=64, max_wait_ms=1.0,
        cache_size=4096, zipf=1.3, trace=None, slo=None, flight=None, flight_latency_ms=None,
        metrics_port=None, sample=None, sample_interval=0.25)
    if telemetry:
        args.trace = os.path.join(tmp, "serve_trace.json")
        args.slo, args.flight, args.metrics_port = OPERATED_SLO, FLIGHT_RING, 0
        args.sample = os.path.join(tmp, "serve_samples.jsonl")
    return args


def operate_service(ops, schema, trees, ens, tmp, dev="cuda"):
    """Phase 9(a): phase 2's requests through ``serve_relational``'s
    wiring, telemetry off, then on (module docstring)."""
    from repro_torch.core import QueryCounter
    from repro_torch.launch import serve_relational as sr
    from repro_torch.serving import ModelRegistry, compile_ensemble

    group = schema.label_table
    n_rows = schema.table(group).n_rows
    out = {}
    for mode in ("off", "on"):
        args = serve_args(tmp, mode == "on")
        registry = ModelRegistry()
        counter = QueryCounter()
        registry.publish(compile_ensemble(schema, trees, counter=counter))
        w = sr.wire(args, registry, group)
        probe = None
        if mode == "on":
            w.flight.out_dir = tmp

            def probe(stage, url=w.telemetry.url):
                paths = ENDPOINTS if stage == "mid" else ENDPOINTS[:1]
                return {p: fetch(url(p)) for p in paths}
        sync(dev)
        ops.reset_launches()                               # the served run starts here
        served = asyncio.run(sr.drive(w.service, n_rows, args.requests, args.concurrency,
                                      args.zipf, registry, schema, args, counter,
                                      telemetry=w.telemetry, hot_swap=False, probe=probe))
        sync(dev)
        launches = ops.launches                            # ... and ends here
        if served["shed_chunks"] or w.service.stats.errors:
            raise AssertionError(f"operate[{mode}]: {served['shed_chunks']} chunks shed, "
                                 f"{w.service.stats.errors} errors")
        bad = int(np.sum(np.asarray(served["answers"], np.float32)
                         != grouped_means(ens, group, served["ids"])))
        if bad:
            raise AssertionError(f"operate[{mode}]: {bad} of {args.requests} answers differ "
                                 f"from phase 2's grouped_cached means")
        if launches != len(schema.join_tree(group).edges):
            raise AssertionError(f"operate[{mode}]: segment_sum launched {launches} times, "
                                 f"expected one pass's {len(schema.join_tree(group).edges)}")
        rec = {k: served[k] for k in ("qps", "p50_ms", "p99_ms", "batches", "cache_hit_rate")}
        rec["launches"] = launches
        if mode == "on":
            stats = w.service.stats_snapshot()
            dump = w.flight.trigger("chip_smoke forced dump", phase="9a")
            files = sr.finish(args, w)
            mid, end = served["probes"]["mid"], served["probes"]["end"]
            codes = {p: c for p, (c, _) in mid.items()}
            if (any(codes[p] != 200 for p in ENDPOINTS if p != "/healthz")
                    or codes["/healthz"] not in (200, 503) or end["/metricsz"][0] != 200):
                raise AssertionError(f"operate: endpoints answered {codes}, then "
                                     f"/metricsz {end['/metricsz'][0]}")
            n_mid = prom_value(mid["/metricsz"][1], "repro_service_requests")
            n_end = prom_value(end["/metricsz"][1], "repro_service_requests")
            if not n_mid < n_end == stats["requests"]:
                raise AssertionError(f"operate: repro_service_requests mid {n_mid}, end {n_end}, "
                                     f"service {stats['requests']}")
            doc = json.loads(Path(args.trace).read_text())
            n_batch_spans = sum(e["name"] == "service.batch" for e in doc["traceEvents"])
            if n_batch_spans != stats["batches"]:
                raise AssertionError(f"operate: {n_batch_spans} service.batch spans for "
                                     f"{stats['batches']} batches")
            if dump is None:
                raise AssertionError("operate: the forced flight trigger wrote no dump")
            fl = json.loads(Path(dump).read_text())["traceEvents"]
            n_spans = sum(e["ph"] == "X" for e in fl)
            if not (0 < n_spans <= FLIGHT_RING and [e["ph"] for e in fl].count("i") == 1):
                raise AssertionError(f"operate: the flight dump holds {n_spans} spans")
            health = json.loads(mid["/healthz"][1])
            rec.update(slo=served["slo"], health_mid=health["state"],
                       requests_mid=n_mid, requests_end=n_end, trace_spans=files["trace_spans"],
                       batch_spans=n_batch_spans, flight_dump_spans=n_spans,
                       samples=files["samples"],
                       tracez_spans=len(json.loads(mid["/tracez"][1])["spans"]))
        out[mode] = rec
        del registry, w
    on, off = out["on"], out["off"]
    slo = on["slo"]
    log(f"  operate (a): telemetry on {on['qps']:.0f} QPS, p50 {on['p50_ms']:.3f} / p99 "
        f"{on['p99_ms']:.3f} ms; off {off['qps']:.0f} QPS, p50 {off['p50_ms']:.3f} / p99 "
        f"{off['p99_ms']:.3f} ms; /metricsz requests mid {on['requests_mid']:.0f}, end "
        f"{on['requests_end']:.0f}; {on['batch_spans']} service.batch spans of "
        f"{on['trace_spans']}; flight dump {on['flight_dump_spans']} spans; "
        f"{on['samples']} samples; SLO {slo['state']} "
        + ", ".join(f"{n} burn {o['burn_fast']:.3f}/{o['burn_slow']:.3f} [{o['state']}]"
                    for n, o in slo["objectives"].items())
        + "; answers bit-equal to phase 2's")
    return out


def stacked_ab(ops, schema, trees, ens, dev="cuda"):
    """Phase 9(b): four variants in one stacked pass (module docstring)."""
    from repro_torch.core import BoostConfig, Booster
    from repro_torch.serving import ModelRegistry, compile_ensemble, stack_ensembles

    t0 = time.perf_counter()
    variants = [Booster(schema, BoostConfig(n_trees=5, depth=3, mode="sketch", ssr_mode="off",
                                            seed=seed, lr=lr)).fit()[0]
                for seed, lr in AB_VARIANTS]
    sync(dev)
    out = {"train_s": time.perf_counter() - t0, "tables": {}}
    models = [ens] + [compile_ensemble(schema, t) for t in variants]
    registry = ModelRegistry()
    versions = [registry.publish(m) for m in models]
    st = registry.stacked()
    C = st.factors[schema.names[0]].shape[1]
    if C != sum(m.total_leaves for m in models) or st.ensembles != models:
        raise AssertionError(f"stacked: {C} channels over {st.n_models} models")
    st16 = stack_ensembles([compile_ensemble(schema, m.trees, factor_dtype=torch.bfloat16)
                            for m in models])
    launches = 0
    for t in schema.names:
        edges = len(schema.join_tree(t).edges)
        sync(dev)
        ops.reset_launches()                               # the stacked pass starts here
        got = st.score_grouped(t)
        sync(dev)
        n_stacked = ops.launches                           # ... and ends here
        launches += n_stacked
        ops.reset_launches()
        own = [m.score_grouped(t) for m in models]
        sync(dev)
        n_separate = ops.launches
        if (n_stacked, n_separate) != (edges, len(models) * edges):
            raise AssertionError(f"stacked {t}: {n_stacked} launches stacked and {n_separate} "
                                 f"separate, for {edges} edges a pass")
        for m, ((tot, cnt), (want_tot, want_cnt)) in enumerate(zip(got, own)):
            if not (torch.equal(tot, want_tot) and torch.equal(cnt, want_cnt)):
                raise AssertionError(f"stacked {t}: model {m} differs from its own pass")
        del got, own
        c32 = st._sp(st._sem, st.factors, group_by=t)
        c16 = st16._sp(st16._sem, st16.factors, group_by=t).float()
        ratio = float(((c16 - c32).abs() / (BF16_ULP * c32.abs()).clamp(min=1e-30)).max())
        if not bool(((c16 - c32).abs() <= BF16_ULP * c32.abs()).all()):
            raise AssertionError(f"stacked {t}: bf16 counts past 2^-8 of the f32 ones "
                                 f"({ratio:.3f} of the limit)")
        del c32, c16
        rec = {"edges": edges, "launches_stacked": n_stacked, "launches_separate": n_separate,
               "stacked_ms": cuda_ms(lambda: st.score_grouped(t), max_reps=10),
               "separate_ms": cuda_ms(lambda: [m.score_grouped(t) for m in models], max_reps=10),
               "stacked_bf16_ms": cuda_ms(lambda: st16.score_grouped(t), max_reps=10),
               "bf16_err_over_limit": ratio}
        out["tables"][t] = rec
        log(f"  stacked (b) {t:<5}: one pass at C={C} {rec['stacked_ms']:.3f} ms (bf16 "
            f"{rec['stacked_bf16_ms']:.3f}) against 4 passes {rec['separate_ms']:.3f} ms; "
            f"launches {n_stacked} / {n_separate}; every model bit-equal to its own pass; "
            f"bf16 counts at {ratio:.3f} of 2^-8")
    if registry.stacked() is not st:
        raise AssertionError("stacked: stacked() did not return its cached object")
    registry.swap(versions[-1], models[1])
    st2 = registry.stacked()
    if st2 is st or st2.ensembles[-1] is not models[1] or registry.stacked() is not st2:
        raise AssertionError("stacked: a swap did not give a new stacked object")
    same = [all(torch.equal(a.leaf, b.leaf) for a, b in zip(trees, v)) for v in variants]
    out.update(channels=C, launches=launches, variants_equal_to_phase2=same)
    log(f"  stacked (b): variants trained in {out['train_s']:.2f}s (trees equal to phase 2's: "
        f"{same}); stacked() cached until a swap")
    return out


def start_writer(schema, trees, wal_dir: str, checkpoint: int, last: int, dev):
    """A one-process writer (phases 9 (c) and 10 (d)): a ``MaintainedScorer``
    of ``schema`` and ``trees`` logging to a ``WalWriter`` in ``wal_dir``,
    phase 8's batches 1..``last`` applied and both roots refreshed after
    each, a checkpoint after batch ``checkpoint``.  Returns (writer, its WAL,
    its batch step ``step(b)``, batch 17 growing dim0 by 2,048 rows)."""
    import os

    from repro_torch.core import QueryCounter
    from repro_torch.incremental import MaintainedScorer
    from repro_torch.incremental.recover import save_checkpoint
    from repro_torch.incremental.wal import WalWriter
    from repro_torch.serving import compile_ensemble

    writer = MaintainedScorer(compile_ensemble(schema, trees), counter=QueryCounter())
    for r in MAINTAIN_ROOTS:
        writer.grouped_cached(r)
    wal = WalWriter(wal_dir, sync_every=8).attach(writer.state)
    rng, mint = np.random.default_rng(8), KeyMint(schema)   # phase 8's batches

    def step(b):
        batch, _ = maintain_batch(rng, writer, mint, grow_rows=2048 if b == 17 else 0)
        writer.apply(batch)
        for r in MAINTAIN_ROOTS:
            writer.grouped_cached(r)
        sync(dev)

    for b in range(1, last + 1):
        step(b)
        if b == checkpoint:
            save_checkpoint(writer.state, os.path.join(wal_dir, "ckpt"))
    return writer, wal, step


def follow_writer(ops, schema, trees, tmp, dev="cuda"):
    """Phase 9(c): a WAL-follower replica of a live writer (module
    docstring)."""
    import os

    from repro_torch.core import QueryCounter
    from repro_torch.launch import serve_relational as sr
    from repro_torch.serving import ModelRegistry, RelationalScoringService, compile_ensemble

    roots = MAINTAIN_ROOTS
    wal_dir = os.path.join(tmp, "wal")
    writer, wal, step = start_writer(schema, trees, wal_dir, FOLLOW_CHECKPOINT,
                                     FOLLOW_CHECKPOINT, dev)
    t0 = time.perf_counter()
    rcounter = QueryCounter()
    replica, follower, rep = sr.open_follower(compile_ensemble(schema, trees), wal_dir,
                                              poll_ms=10.0, counter=rcounter)
    replica.grouped_cached("fact")
    sync(dev)
    recover_s = time.perf_counter() - t0
    if (rep.checkpoint_lsn, rep.replayed) != (FOLLOW_CHECKPOINT, 0):
        raise AssertionError(f"follow: recovered {rep}")
    slo = sr.make_slo("staleness=5s", follower=True)
    extra = sr.follower_staleness(follower, grace_s=5.0)
    registry = ModelRegistry()
    registry.publish(replica)
    svc = RelationalScoringService(registry, "fact", max_batch=64, max_wait_ms=1.0,
                                   cache_size=4096, slo=slo, extra_staleness=extra)
    writer_ms, errors = [], []
    writer_edges0, replica_edges0 = writer.counter.edges, rcounter.edges

    def write():
        try:
            t_start = time.perf_counter()
            for k, b in enumerate(range(FOLLOW_CHECKPOINT + 1, FOLLOW_LAST + 1)):
                time.sleep(max(0.0, t_start + k * FOLLOW_PERIOD_S - time.perf_counter()))
                t = time.perf_counter()
                step(b)
                writer_ms.append((time.perf_counter() - t) * 1e3)
            wal.close()
        except BaseException as e:       # noqa: BLE001 — re-raised on the main thread
            errors.append(e)

    n_rows = schema.table("fact").n_rows
    ids = np.minimum(np.random.default_rng(3).zipf(1.3, 1 << 16) - 1, n_rows - 1)
    states, extras = [], []

    async def serve_tail(thread):
        await svc.start()
        answered, k = 0, 0
        while thread.is_alive():
            chunk = ids[(k * 256) % len(ids):][:256].tolist()
            answered += len(await svc.score_many(chunk))
            k += 1
            rep_ = slo.evaluate()
            states.append((rep_["state"], rep_["objectives"]["staleness"]["state"]))
            extras.append(extra())
            await asyncio.sleep(0.005)
        await svc.stop()
        return answered

    sync(dev)
    ops.reset_launches()                                   # the tail starts here
    thread = threading.Thread(target=write, name="wal-writer")
    t0 = time.perf_counter()
    thread.start()
    answered = asyncio.run(serve_tail(thread))
    thread.join()
    follower.stop(drain=True)
    sync(dev)
    tail_s = time.perf_counter() - t0
    launches = ops.launches                                # ... and ends here
    writer_edges, replica_edges = writer.counter.edges - writer_edges0, rcounter.edges - replica_edges0
    if errors:
        raise errors[0]
    if follower.applied_lsn != writer.data_version or writer.data_version != FOLLOW_LAST:
        raise AssertionError(f"follow: applied lsn {follower.applied_lsn}, writer at "
                             f"{writer.data_version}")
    for r in roots:
        if not all(torch.equal(a, b) for a, b in zip(replica.grouped_cached(r),
                                                      writer.grouped_cached(r))):
            raise AssertionError(f"follow: the replica's {r} scores differ from the writer's")
    stale_states = [s for _, s in states]
    if "unhealthy" in stale_states or svc.stats.shed or svc.stats.errors:
        raise AssertionError(f"follow: staleness states {sorted(set(stale_states))}, shed "
                             f"{svc.stats.shed}, errors {svc.stats.errors}")
    if not launches > 0:
        raise AssertionError("follow: no segment_sum launch during the tail")
    registry2 = ModelRegistry()
    registry2.publish(replica)
    svc2 = RelationalScoringService(registry2, "fact", max_batch=64, max_wait_ms=1.0)

    async def final():
        await svc2.start()
        try:
            return await svc2.score_many(ids[:256].tolist())
        finally:
            await svc2.stop()

    got = np.asarray(asyncio.run(final()), np.float32)
    bad = int(np.sum(got != grouped_means(replica, "fact", ids[:256])))
    if bad:
        raise AssertionError(f"follow: {bad} of 256 answers differ from the replica's means")
    lag = follower.apply_lag_s.summary()
    out = {"recover_s": recover_s, "tail_s": tail_s, "records": FOLLOW_LAST - FOLLOW_CHECKPOINT,
           "applied_lsn": follower.applied_lsn, "answered": answered,
           "lag_p50_s": lag["p50"], "lag_p99_s": lag["p99"], "lag_max_s": lag["max"],
           "writer_ms": {"p50": pctl(writer_ms, 50), "p99": pctl(writer_ms, 99)},
           "launches": launches, "writer_edges": writer_edges, "replica_edges": replica_edges,
           "slo_states": sorted(set(s for s, _ in states)),
           "staleness_states": sorted(set(stale_states)),
           "extra_staleness_max_s": max(extras, default=0.0),
           "service_staleness_s": svc.stats.staleness_s.value}
    log(f"  follow (c): recovered at lsn {rep.recovered_lsn} in {recover_s:.2f}s; tailed "
        f"{out['records']} records in {tail_s:.2f}s to lsn {follower.applied_lsn}, replication "
        f"lag p50 {lag['p50'] * 1e3:.1f} / p99 {lag['p99'] * 1e3:.1f} ms (max "
        f"{lag['max'] * 1e3:.1f}); writer p50 {out['writer_ms']['p50']:.1f} / p99 "
        f"{out['writer_ms']['p99']:.1f} ms a batch; {answered} requests answered during the "
        f"tail, SLO states {out['slo_states']}, staleness {out['staleness_states']} (extra max "
        f"{out['extra_staleness_max_s']:.3f}s); segment_sum launches {launches} (edges: writer "
        f"{out['writer_edges']}, replica {out['replica_edges']}); replica bit-equal to the "
        f"writer on {list(roots)}, 256 answers its means")
    return out


def phase_operate(ops, schema, trees, ens, dev="cuda"):
    """Phase 9 (module docstring): (a), (b) and (c), then their peak
    memory; returns their records."""
    import tempfile

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = {"service": operate_service(ops, schema, trees, ens, tmp, dev)}
        gc.collect()
        out["stacked"] = stacked_ab(ops, schema, trees, ens, dev)
        gc.collect()
        torch.cuda.empty_cache()
        out["follow"] = follow_writer(ops, schema, trees, tmp, dev)
    gc.collect()
    torch.cuda.empty_cache()
    out.update(seconds=time.perf_counter() - t0,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches={"service": out["service"]["on"]["launches"],
                         "stacked": out["stacked"]["launches"],
                         "follow": out["follow"]["launches"]})
    log(f"  phase 9 took {out['seconds']:.1f}s, peak memory {out['peak_gib']:.2f} GiB "
        f"allocated; segment_sum launches {out['launches']}")
    return out


# ----------------------------------------------------------------- phase 10 --
DP_WORLD = 2                       # ranks sharing the one card over gloo
DP_ROOTS = ("fact", "dim0")
DP_BATCHES, DP_OPS = 4, 8          # delta_stream batches and ops a batch, (c)
DP_TIMEOUT_S = 600.0               # every rank joined within this, or the phase fails
DP_FIT_ROWS = 1 << 18              # (b)'s fits: the first 2^18 of phase 2's fact rows
DP_FOLLOW = (8, 10, 26)            # (d): the writer's checkpoint, its LSN at recovery, its last
DP_FOLLOW_ANSWERS = 256            # (d): rank 0's answers held to their versions' means


def snap16(x):
    """Labels on the 1/16 grid: every label sum of the fit is exact in
    float32, so the cross-rank sums are too."""
    return np.round(np.asarray(x) * 16.0) / 16.0


def snap_delta(schema, batch):
    """``snap16`` for labels arriving through a delta batch."""
    from repro_torch.incremental import TableDelta

    lt, lc = schema.label_table, schema.label_column
    out = []
    for d in batch:
        ins, upd = d.inserts, d.updates
        if d.table == lt and ins and lc in ins:
            ins = {**ins, lc: snap16(ins[lc])}
        if d.table == lt and upd and lc in upd[1]:
            upd = (upd[0], {**upd[1], lc: snap16(upd[1][lc])})
        out.append(TableDelta(d.table, inserts=ins, deletes=d.deletes, updates=upd))
    return out


def dp_rank(rank: int, world: int, tmp: str, dev: str) -> None:
    """One rank of phase 10 (module docstring): joins the gloo group,
    runs the sharded main path with the counts at 0, then the one-process
    references, holds the gates and writes its numbers."""
    import datetime
    import pickle

    import torch.distributed as dist

    torch.set_num_threads(max(1, 8 // world))
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
    try:
        with open(f"{tmp}/inputs.pkl", "rb") as fh:
            inp = pickle.load(fh)
        out = dp_work(rank, world, inp, dev)
        with open(f"{tmp}/rank{rank}.json", "w") as fh:
            json.dump(out, fh)
    finally:
        dist.destroy_process_group()


def dp_work(rank: int, world: int, inp: dict, dev: str) -> dict:
    from repro_torch.core import BoostConfig, Booster, QueryCounter, Schema, Table
    from repro_torch.core.tree import TreeArrays
    from repro_torch.distributed import spmd
    from repro_torch.incremental import MaintainedScorer
    from repro_torch.kernels.segment_sum import ops
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.obs import disable_tracing, enable_tracing, get_tracer
    from repro_torch.relational.generators import delta_stream
    from repro_torch.serving import compile_ensemble, score_grouped

    if dev == "cpu":                    # a CPU rehearsal counts the plain version's calls
        import repro_torch.core.semiring as sr
        plain = sr.segment_sum

        def counted(vals, seg):
            ops.launches += 1
            return plain(vals, seg)
        sr.segment_sum = counted
    mesh = make_data_mesh(world, device=dev, backend="gloo")
    lt, lc = inp["label"]
    t0 = time.perf_counter()
    schema = Schema([Table(n, {c: (snap16(v) if (n, c) == (lt, lc) else v)
                               for c, v in cols.items()}, fc)
                     for n, cols, fc in inp["tables"]], label=(lt, lc), device=dev)
    schema_s = time.perf_counter() - t0
    fit_schema = Schema([Table(t.name, {c: v[:DP_FIT_ROWS] for c, v in t.columns.items()}
                               if t.name == "fact" else t.columns, t.feature_columns)
                         for t in schema.tables], label=(lt, lc), device=dev)
    trees = [TreeArrays(*(x.to(dev) for x in t)) for t in inp["trees"]]
    cfg = BoostConfig(n_trees=5, depth=3, mode="sketch", ssr_mode="off")   # phase 2's fit
    names = schema.names
    roots = [r for r in DP_ROOTS if r in names]

    def stream(ms):
        return (snap_delta(schema, b) for b in delta_stream(
            schema, ms.live_rows, seed=21, n_batches=DP_BATCHES, ops_per_batch=DP_OPS))

    def grouped(ms):
        return {r: [x.cpu() for x in ms.grouped_cached(r)] for r in roots}

    # the sharded main path: counts at 0 before it, read after it
    sync(dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    enable_tracing(torch_annotations=False)
    ops.reset_launches()
    t_main = time.perf_counter()
    c_a = QueryCounter()
    with spmd.use_data_mesh(mesh):
        ens = compile_ensemble(schema, trees, counter=c_a)
    fact_sharded = spmd.is_row_sharded(ens.factors["fact"], mesh,
                                       rows=schema.table("fact").n_rows)
    scores, pass_ms = {}, {}
    for t in names:
        sync(dev)
        t0 = time.perf_counter()
        scores[t] = [x.cpu() for x in score_grouped(ens, t)]
        sync(dev)
        pass_ms[t] = (time.perf_counter() - t0) * 1e3
    del ens
    t0 = time.perf_counter()
    with spmd.use_data_mesh(mesh):
        booster = Booster(fit_schema, cfg)
    fit_n, _ = booster.fit()
    sync(dev)
    fit_s = time.perf_counter() - t0
    c_c = QueryCounter()
    with spmd.use_data_mesh(mesh):
        ms = MaintainedScorer(compile_ensemble(schema, trees), counter=c_c)
    maint = [grouped(ms)]
    batch_ms = []
    for batch in stream(ms):
        sync(dev)
        t0 = time.perf_counter()
        ms.apply(batch)
        maint.append(grouped(ms))
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    del ms
    sync(dev)
    main_s = time.perf_counter() - t_main
    launches = ops.launches
    edges = c_a.count * (len(names) - 1) + booster.counter.edges + c_c.edges
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30 if dev == "cuda" else 0.0
    events = list(get_tracer().events)
    disable_tracing()
    coll = {}
    for kind in ("all_reduce", "all_gather"):
        evs = [e for e in events if e["name"] == f"spmd.{kind}"]
        ms_ = [e["dur_ms"] for e in evs]
        coll[kind] = {"n": len(evs), "p50_ms": pctl(ms_, 50) if ms_ else None,
                      "p99_ms": pctl(ms_, 99) if ms_ else None,
                      "bytes_mean": float(np.mean([e["bytes"] for e in evs])) if evs else None}

    # the one-process references, outside the counted run
    with spmd.use_data_mesh(None):
        t0 = time.perf_counter()
        fit_1, _ = Booster(fit_schema, cfg).fit()
        sync(dev)
        fit1_s = time.perf_counter() - t0
        ms1 = MaintainedScorer(compile_ensemble(schema, trees))
        maint1 = [grouped(ms1)]
        for batch in stream(ms1):
            ms1.apply(batch)
            maint1.append(grouped(ms1))
    del ms1

    tag = f"data parallel rank {rank}/{world}"
    for t in names:                                                       # (a)
        want = inp["scores"][t]
        if not all(torch.equal(g, w) for g, w in zip(scores[t], want)):
            raise AssertionError(f"{tag}: (a) scores grouped by {t} differ from phase 2's")
    same = len(fit_n) == len(fit_1) and all(                              # (b)
        torch.equal(a.feat, b.feat) and torch.equal(a.thr, b.thr) and torch.equal(a.leaf, b.leaf)
        for a, b in zip(fit_n, fit_1))
    if not same:
        raise AssertionError(f"{tag}: (b) the sharded fit's trees differ from one process's")
    for i, (g, w) in enumerate(zip(maint, maint1)):                        # (c)
        for r in roots:
            if not all(torch.equal(x, y) for x, y in zip(g[r], w[r])):
                raise AssertionError(f"{tag}: (c) {r} after batch {i} differs from one "
                                     f"process's scorer")
    if len(maint) != DP_BATCHES + 1:
        raise AssertionError(f"{tag}: (c) ran {len(maint) - 1} batches, wants {DP_BATCHES}")
    if not fact_sharded:
        raise AssertionError(f"{tag}: the fact table's factor is not a row block")
    if launches != edges or launches == 0:
        raise AssertionError(f"{tag}: segment_sum launches {launches}, the counters' edges "
                             f"{edges}")
    follow = dp_follow(rank, inp, mesh, schema, trees, roots, dev)
    return {"rank": rank, "schema_s": schema_s, "main_s": main_s, "pass_ms": pass_ms,
            "fit_s": fit_s, "fit_one_process_s": fit1_s, "batch_ms": batch_ms,
            "fit_rows": fit_schema.table("fact").n_rows,
            "launches": launches, "edges": edges, "collectives": coll, "peak_gib": peak_gib,
            "queries": {"scores": c_a.count, "fit": booster.counter.count,
                        "maintain_edges": c_c.edges}, "follow": follow}


def span_stats(events, name: str) -> dict:
    """Count and p50/p99 ms of the tracer's ``name`` spans."""
    ms_ = [e["dur_ms"] for e in events if e["name"] == name]
    return {"n": len(ms_), "p50_ms": pctl(ms_, 50) if ms_ else None,
            "p99_ms": pctl(ms_, 99) if ms_ else None}


def follow_mesh_serve(served, follower, slo, extra, done: str, ids, dev):
    """Phase 10 (d)'s traffic on rank 0 while the follower tails: chunks of
    256 requests on the published versions until the writer is done and
    the follower applied its last LSN; each chunk with the version before
    and after it, and the SLO's states.  Returns (chunks, states, the
    service's shed and failed requests, the writer's last LSN)."""
    import os

    from repro_torch.serving import ModelRegistry, RelationalScoringService

    registry = ModelRegistry()
    registry.publish(served)
    svc = RelationalScoringService(registry, "fact", max_batch=64, max_wait_ms=1.0,
                                   cache_size=4096, slo=slo, extra_staleness=extra)
    chunks, states, final = [], [], [None]

    async def go():
        await svc.start()
        k, deadline = 0, time.monotonic() + DP_TIMEOUT_S / 2
        while final[0] is None or follower.applied_lsn < final[0]:
            if time.monotonic() > deadline:
                raise AssertionError(f"follow (d): the follower at lsn {follower.applied_lsn}, "
                                     f"the writer's last {final[0]}")
            if final[0] is None and os.path.exists(done):
                final[0] = int(Path(done).read_text())
            chunk = ids[(k * 256) % len(ids):][:256]
            before = served.data_version
            got = await svc.score_many(chunk.tolist())
            chunks.append((before, chunk, np.asarray(got, np.float32), served.data_version))
            rep_ = slo.evaluate()
            states.append((rep_["state"], rep_["objectives"]["staleness"]["state"]))
            k += 1
            await asyncio.sleep(0.005)
        await svc.stop()

    asyncio.run(go())
    return chunks, states, (svc.stats.shed, svc.stats.errors), final[0]


def dp_follow(rank, inp, mesh, schema, trees, roots, dev) -> dict:
    """Phase 10 (d) on one rank (module docstring): the writer's log
    followed on the mesh (``serve_relational.open_mesh_follower``), rank 0
    serving meanwhile, the counts at 0 before the recovery and read after
    the stop; then the one-process follower and the gates."""
    import os

    from repro_torch.core import QueryCounter
    from repro_torch.distributed import spmd
    from repro_torch.incremental import MaintainedScorer
    from repro_torch.incremental.recover import load_checkpoint
    from repro_torch.incremental.wal import read_records, wal_path
    from repro_torch.kernels.segment_sum import ops
    from repro_torch.launch import serve_relational as sr
    from repro_torch.obs import disable_tracing, enable_tracing, get_tracer
    from repro_torch.serving import compile_ensemble

    wal_dir, tmp = inp["wal_dir"], inp["tmp"]
    ckpt, before, _ = DP_FOLLOW
    seen, apply_ms, publish_ms, t_applied = {}, [], [], [None]
    tag = f"follow (d) rank {rank}"

    def on_publish(lsn, snap):
        seen[lsn] = {r: [x.cpu() for x in snap.grouped_cached(r)] for r in roots}
        if t_applied[0] is not None:
            publish_ms.append((time.perf_counter() - t_applied[0]) * 1e3)

    sync(dev)
    enable_tracing(torch_annotations=False)
    get_tracer().clear()
    ops.reset_launches()                                   # the follower's path starts here
    counter = QueryCounter()
    t0 = time.perf_counter()
    with spmd.use_data_mesh(mesh):
        ens = compile_ensemble(schema, trees, counter=counter)
    served, follower, rep = sr.open_mesh_follower(ens, wal_dir, 10.0, mesh, roots, counter,
                                                  on_publish)
    sync(dev)
    recover_s = time.perf_counter() - t0
    real_apply = follower.apply_fn

    def timed_apply(deltas):
        sync(dev)
        t = time.perf_counter()
        real_apply(deltas)
        sync(dev)
        t_applied[0] = time.perf_counter()
        apply_ms.append((t_applied[0] - t) * 1e3)
    follower.apply_fn = timed_apply
    out = {"recovered_lsn": rep.recovered_lsn, "checkpoint_lsn": rep.checkpoint_lsn,
           "replayed": rep.replayed, "recover_s": recover_s}
    get_tracer().clear()                                   # the tail's collectives from here
    Path(f"{tmp}/follow_ready{rank}").touch()
    t0 = time.perf_counter()
    if rank == 0:
        slo = sr.make_slo("staleness=5s", follower=True)
        extra = sr.follower_staleness(follower, grace_s=5.0)
        n_rows = schema.table("fact").n_rows
        ids = np.minimum(np.random.default_rng(3).zipf(1.3, 1 << 16) - 1, n_rows - 1)
        follower.start()
        try:
            chunks, states, (shed, errors), final = follow_mesh_serve(
                served, follower, slo, extra, f"{tmp}/follow_done", ids, dev)
        finally:
            follower.stop(drain=True)
        lag = follower.apply_lag_s.summary()
        out.update(lag_p50_s=lag["p50"], lag_p99_s=lag["p99"], lag_max_s=lag["max"])
    else:
        follower.run()
        final = int(Path(f"{tmp}/follow_done").read_text())
    sync(dev)
    out.update(tail_s=time.perf_counter() - t0, applied_lsn=follower.applied_lsn,
               rounds=follower.rounds, final_lsn=final)
    launches, edges = ops.launches, counter.edges          # ... and ends here
    events = list(get_tracer().events)
    disable_tracing()
    out["collectives"] = {k: span_stats(events, f"spmd.{k}")
                          for k in ("all_reduce", "all_gather", "broadcast")}

    with spmd.use_data_mesh(None):                         # the one-process follower
        one = MaintainedScorer(compile_ensemble(schema, trees))
        state, lsn, _ = load_checkpoint(schema, os.path.join(wal_dir, "ckpt"))
        one.adopt_state(state)
        want = {lsn: {r: [x.cpu() for x in one.grouped_cached(r)] for r in roots}}
        for rec_lsn, deltas, _, _ in read_records(wal_path(wal_dir)):
            if rec_lsn > lsn:
                one.apply(deltas)
                want[rec_lsn] = {r: [x.cpu() for x in one.grouped_cached(r)] for r in roots}
    del one

    if (rep.checkpoint_lsn, rep.recovered_lsn) != (ckpt, before):
        raise AssertionError(f"{tag}: recovered {rep}, the writer checkpointed at {ckpt} and "
                             f"stood at {before}")
    if follower.applied_lsn != final or sorted(seen) != list(range(ckpt, final + 1)):
        raise AssertionError(f"{tag}: applied through {follower.applied_lsn}, published "
                             f"{sorted(seen)}, the writer's last lsn {final}")
    for lsn, got in seen.items():
        for r in roots:
            if not all(torch.equal(a, b) for a, b in zip(got[r], want[lsn][r])):
                raise AssertionError(f"{tag}: {r} at lsn {lsn} differs from the one-process "
                                     f"follower's")
    if launches != edges or launches == 0:
        raise AssertionError(f"{tag}: segment_sum launches {launches}, the counter's edges "
                             f"{edges}")
    out.update(launches=launches, edges=edges, apply_ms=apply_ms, publish_ms=publish_ms)
    if rank == 0:
        checked = 0
        for v0, ids_, got, v1 in chunks:
            if v0 != v1 or checked >= DP_FOLLOW_ANSWERS:
                continue
            tot, cnt = seen[v0]["fact"]
            mean = (tot / torch.clamp(cnt, min=1.0))[torch.from_numpy(ids_)].numpy()
            bad = int(np.sum(got != mean))
            if bad:
                raise AssertionError(f"{tag}: {bad} of {len(ids_)} answers at version {v0} "
                                     f"differ from its means")
            checked += len(ids_)
        stale = sorted(set(s for _, s in states))
        if checked < DP_FOLLOW_ANSWERS or "unhealthy" in stale or shed or errors:
            raise AssertionError(f"{tag}: {checked} answers checked, staleness {stale}, shed "
                                 f"{shed}, failed {errors}")
        out.update(answered=sum(len(c[1]) for c in chunks), checked=checked,
                   slo_states=sorted(set(s for s, _ in states)), staleness_states=stale)
    return out


def follow_writer_tail(wal, step, tmp: str, procs, ms: list, errors: list) -> None:
    """Phase 10 (d)'s live writes, on a thread of this process: once every
    rank has recovered, batches ``DP_FOLLOW[1]`` + 1..``DP_FOLLOW[2]``, one
    every ``FOLLOW_PERIOD_S``, then the log closed and its last LSN
    written to ``follow_done``."""
    import os

    try:
        deadline = time.monotonic() + DP_TIMEOUT_S
        while not all(os.path.exists(f"{tmp}/follow_ready{r}") for r in range(DP_WORLD)):
            if time.monotonic() > deadline or any(p.exitcode not in (None, 0) for p in procs):
                return
            time.sleep(0.05)
        t_start = time.perf_counter()
        for k, b in enumerate(range(DP_FOLLOW[1] + 1, DP_FOLLOW[2] + 1)):
            time.sleep(max(0.0, t_start + k * FOLLOW_PERIOD_S - time.perf_counter()))
            t = time.perf_counter()
            step(b)
            ms.append((time.perf_counter() - t) * 1e3)
        wal.close()
        Path(f"{tmp}/follow_done").write_text(str(DP_FOLLOW[2]))
    except BaseException as e:           # noqa: BLE001 — re-raised on the main thread
        errors.append(e)


def phase_data_parallel(schema, trees, scores, serve_times, dev="cuda"):
    """Phase 10 (module docstring): two ranks on the one card over gloo,
    spawned, joined within ``DP_TIMEOUT_S``; returns their records."""
    import multiprocessing
    import pickle
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        wal_dir = f"{tmp}/wal"
        t1 = time.perf_counter()
        writer, wal, step = start_writer(schema, trees, wal_dir, *DP_FOLLOW[:2], dev)
        writer_start_s = time.perf_counter() - t1
        with open(f"{tmp}/inputs.pkl", "wb") as fh:
            pickle.dump({"tables": [(t.name, t.columns, t.feature_columns)
                                    for t in schema.tables],
                         "label": (schema.label_table, schema.label_column),
                         "trees": [(t.feat.cpu(), t.thr.cpu(), t.leaf.cpu()) for t in trees],
                         "scores": {n: [x.cpu() for x in v] for n, v in scores.items()},
                         "wal_dir": wal_dir, "tmp": tmp}, fh)
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=dp_rank, args=(r, DP_WORLD, tmp, dev))
                 for r in range(DP_WORLD)]
        for p in procs:
            p.start()
        writer_ms, errors = [], []
        tail = threading.Thread(target=follow_writer_tail, name="wal-writer",
                                args=(wal, step, tmp, procs, writer_ms, errors))
        tail.start()
        deadline = time.monotonic() + DP_TIMEOUT_S
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                break                                 # one rank failed: stop the others
            time.sleep(0.5)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
        tail.join()
        codes = [p.exitcode for p in procs]
        if errors:
            raise errors[0]
        if codes != [0] * DP_WORLD:
            raise AssertionError(f"data parallel: ranks exited with {codes} (a kill: one "
                                 f"failed, or {DP_TIMEOUT_S:.0f} s passed)")
        ranks = [json.loads(Path(f"{tmp}/rank{r}.json").read_text()) for r in range(DP_WORLD)]
        if writer.data_version != DP_FOLLOW[2]:
            raise AssertionError(f"follow (d): the writer at lsn {writer.data_version}")
        del writer, wal, step
    out = {"seconds": time.perf_counter() - t0, "ranks": ranks,
           "launches": sum(r["launches"] for r in ranks),
           "follow_launches": sum(r["follow"]["launches"] for r in ranks),
           "writer_start_s": writer_start_s, "writer_ms": writer_ms,
           "phase2_pass_ms": {n: serve_times[f"score_grouped_{n}_s"] * 1e3 for n in scores}}
    for r in ranks:
        c = r["collectives"]
        log(f"  rank {r['rank']}: schema {r['schema_s']:.2f} s, main path {r['main_s']:.2f} s, "
            f"fit {r['fit_s']:.2f} s on {r['fit_rows']} fact rows (one process "
            f"{r['fit_one_process_s']:.2f} s), "
            f"launches {r['launches']} = edges {r['edges']}, peak {r['peak_gib']:.2f} GiB")
        log(f"    all-reduce a message: n {c['all_reduce']['n']}, p50 "
            f"{c['all_reduce']['p50_ms']} / p99 {c['all_reduce']['p99_ms']} ms, "
            f"{c['all_reduce']['bytes_mean']} bytes mean; all-gather a grouped output: n "
            f"{c['all_gather']['n']}, p50 {c['all_gather']['p50_ms']} / p99 "
            f"{c['all_gather']['p99_ms']} ms, {c['all_gather']['bytes_mean']} bytes mean")
        log("    pass ms by table (sharded, all-gather included / phase 2's one process): "
            + ", ".join(f"{n} {r['pass_ms'][n]:.3f} / {out['phase2_pass_ms'][n]:.3f}"
                        for n in r["pass_ms"]))
        log(f"    delta batches ms: {[round(x, 3) for x in r['batch_ms']]}")
        f = r["follow"]
        c = f["collectives"]
        log(f"    follow (d): recovered at lsn {f['recovered_lsn']} (checkpoint "
            f"{f['checkpoint_lsn']} + {f['replayed']} by broadcast) in {f['recover_s']:.2f} s, "
            f"applied through lsn {f['applied_lsn']} in {f['tail_s']:.2f} s ({f['rounds']} "
            f"rounds); apply ms a record p50 {pctl(f['apply_ms'], 50):.1f} / p99 "
            f"{pctl(f['apply_ms'], 99):.1f}, publish (both roots scored) p50 "
            f"{pctl(f['publish_ms'], 50):.1f} / p99 {pctl(f['publish_ms'], 99):.1f}; "
            f"segment_sum launches {f['launches']} = edges {f['edges']}; all-reduce "
            f"{c['all_reduce']}, all-gather {c['all_gather']}, broadcast {c['broadcast']}")
        if r["rank"] == 0:
            log(f"      rank 0: replication lag a record p50 {f['lag_p50_s'] * 1e3:.1f} / p99 "
                f"{f['lag_p99_s'] * 1e3:.1f} ms (max {f['lag_max_s'] * 1e3:.1f}); "
                f"{f['answered']} requests answered during the tail, {f['checked']} held to "
                f"their versions' means; SLO states {f['slo_states']}, staleness "
                f"{f['staleness_states']}")
    log(f"  follow (d): the writer's first {DP_FOLLOW[1]} batches and checkpoint "
        f"{out['writer_start_s']:.2f} s, its live batches p50 {pctl(out['writer_ms'], 50):.1f} / "
        f"p99 {pctl(out['writer_ms'], 99):.1f} ms; every rank bit-equal to the one-process "
        f"follower after each record")
    log(f"  phase 10 took {out['seconds']:.1f}s; gates (a)-(d) held on every rank")
    return out


# ----------------------------------------------------------------- phase 11 --
BRIDGE_TABLE = "fact"                 # the documents: one fact row each
BRIDGE_TREES = 4                      # the paper config's 8 trees cut for phase 20 (d)'s time
RWKV_TRAIN_KERNELS = ("rwkv6_chunk_bwd", "rwkv6_chunk_kernel", "count_sketch_",
                      "unsketch_kernel")


def phase_bridge(ops, schema, dev="cuda"):
    """Phase 11(a): the paper's config fitted on ``schema``, then the
    sampling weights of its fact rows from one compiled pass (module
    docstring).  Returns (record, weights)."""
    from repro_torch import configs
    from repro_torch.core import Booster
    from repro_torch.core.sumprod import SumProd
    from repro_torch.data import relational_example_weights
    from repro_torch.obs import get_registry

    cfg = dataclasses.replace(configs.get("paper_rbrt"), n_trees=BRIDGE_TREES)
    edges = get_registry().counter("sumprod.edges")
    emitted = [0]
    emit = SumProd._emit

    def counted_emit(self, *a, **kw):                              # one message, one edge
        emitted[0] += 1
        return emit(self, *a, **kw)

    sync(dev)
    e0 = edges.value
    with swapped(SumProd, "_emit", counted_emit):
        ops.reset_launches()                                       # main path starts here
        t0 = time.perf_counter()
        booster = Booster(schema, cfg)
        trees, trace = booster.fit()
        sync(dev)
        fit_s = time.perf_counter() - t0
        fit_launches, fit_edges, analytic = ops.launches, emitted[0], edges.value - e0
        ops.reset_launches()
        emitted[0] = 0
        t0 = time.perf_counter()
        w = relational_example_weights(booster, trees, BRIDGE_TABLE)   # ends in a copy to the host
        pass_ms = (time.perf_counter() - t0) * 1e3
        pass_launches, pass_edges = ops.launches, emitted[0]        # ... and ends here
    if not (fit_launches == fit_edges > 0 and pass_launches == pass_edges == schema.n_tables - 1):
        raise AssertionError(f"bridge: segment_sum launches {fit_launches} in the fit ({fit_edges} "
                             f"edges emitted) and {pass_launches} in the weights pass "
                             f"({pass_edges} edges emitted, {schema.n_tables - 1} in the join "
                             f"tree)")
    n = schema.table(BRIDGE_TABLE).n_rows
    # the float64 softmax of the oracle's per-row means, and D, the largest
    # error of a mean that phase 2's gate (1e-4·Σ|ŷ| a group) allows
    tot, cnt, mag = oracle_sums(schema, trees, [BRIDGE_TABLE])[BRIDGE_TABLE]
    cnt = cnt.clamp(min=1.0)
    want, D = torch.softmax(tot / cnt, 0), float((1e-4 * mag / cnt).max())
    del tot, cnt, mag
    rtol = math.expm1(2 * D) + 1e-5
    got = torch.from_numpy(w).to(dev).double()
    err = (got - want).abs()
    total = float(got.sum())
    floor = torch.finfo(torch.float32).tiny              # a float32 weight's least normal value
    if not (w.dtype == np.float32 and w.shape == (n,) and bool((err <= rtol * want + floor).all())
            and abs(total - 1.0) <= 1e-6):
        raise AssertionError(f"bridge: weights {w.dtype} {w.shape} off the oracle's softmax by "
                             f"up to {float((err / want.clamp_min(1e-300)).max())} relative "
                             f"(limit {rtol}), or Σw = {total}")
    ess = 1.0 / float((got ** 2).sum())
    rec = {"config": dataclasses.asdict(cfg), "n_fact": n, "fit_s": fit_s, "queries":
           trace.queries, "fit_launches": fit_launches, "fit_edges": fit_edges,
           "fit_edges_analytic": analytic,
           "pass_ms": pass_ms, "pass_launches": pass_launches,
           "weight_min": float(w.min()), "weight_max": float(w.max()),
           "effective_sample_size": ess, "sum_minus_one": total - 1.0,
           "max_rel_err": float((err / want.clamp_min(1e-300)).max()), "rtol": rtol}
    log(f"  paper_rbrt ({cfg.n_trees} trees, depth {cfg.depth}, {cfg.mode} k {cfg.sketch_k}, "
        f"SSR {cfg.ssr_mode}) on {n:,} documents: fit {fit_s:.2f}s ({trace.queries} queries, "
        f"{fit_launches} segment_sum launches = edges emitted; the counter's analytic edges "
        f"{analytic}); weights pass {pass_ms:.2f} ms "
        f"({pass_launches} launches); weights min {rec['weight_min']:.3e} max "
        f"{rec['weight_max']:.3e}, effective sample size {ess:,.0f} of {n:,}; Σw − 1 "
        f"{total - 1.0:.2e}; max rel err against the oracle's softmax {rec['max_rel_err']:.2e} "
        f"(limit {rtol:.2e})")
    del booster, trees, want, got, err
    return rec, w


def phase_rwkv_train(wops, cops, other_ops, weights, steps: int = 4, batch: int = 8,
                     seq: int = 2048, n_micro: int = 8, dev="cuda", profile: bool = False):
    """Phase 11(b): RWKV-6 1.6B trained at full width through
    ``launch/train.py``'s ``build``, on batches drawn by ``weights`` (module
    docstring)."""
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels.rwkv6_chunk.ref import rwkv6_chunk_ref
    from repro_torch.launch import train as T
    from repro_torch.models import rwkv6
    from repro_torch.tree import leaves

    args = T.parser().parse_args(["--arch", "rwkv6_1_6b", "--full", "--steps", str(steps + 1),
                                  "--batch", str(batch), "--seq", str(seq), "--n-micro",
                                  str(n_micro), "--compress-grads", "8", "--ckpt-every", "0",
                                  "--device", dev])
    t0 = time.perf_counter()
    tr = T.build(args)
    sync(dev)
    init_s = time.perf_counter() - t0
    cfg = tr.model.cfg
    tr.pipe.stop()                                  # the caller wires the weighted pipeline in
    tr.pipe = TokenPipeline(cfg.vocab, batch, seq, seed=1, example_weights=weights)
    host = TokenPipeline(cfg.vocab, batch, seq, seed=1, example_weights=weights)
    try:
        host_first = next(host)
    finally:
        host.stop()
    n_params = sum(p.numel() for p in leaves(tr.params))
    n_sk = sum(p.numel() >= 4 * tr.compressor.ratio for p in leaves(tr.params))
    run = run_steps(tr, n_micro, steps, (wops, cops, *other_ops), lambda: (
        {"rwkv6_chunk": wops.launches, "rwkv6_chunk_bwd": wops.bwd_launches,
         "count_sketch": cops.launches, "count_sketch_unsketch": cops.unsketch_launches},
        {o.__name__: o.launches for o in other_ops}), dev, profile, RWKV_TRAIN_KERNELS)
    launches, others = run["counts"]
    losses, step_s = run["losses"], run["step_s"]
    want = {"rwkv6_chunk": 2 * cfg.n_layers * n_micro * steps,
            "rwkv6_chunk_bwd": cfg.n_layers * n_micro * steps,
            "count_sketch": n_sk * steps, "count_sketch_unsketch": n_sk * steps}
    if not all(math.isfinite(x) for x in losses + [run["warm_loss"]]):
        raise AssertionError(f"rwkv train: a loss is not finite: {run['warm_loss']}, {losses}")
    if launches != want or any(others.values()):
        raise AssertionError(f"rwkv train: launches {launches}, expected {want}; off the path "
                             f"{others}")
    docs = run["warm_batch"]["doc_ids"].cpu().numpy()
    if not np.array_equal(docs, host_first["doc_ids"]):
        raise AssertionError("rwkv train: the first batch's doc_ids differ from a host "
                             "TokenPipeline's for the same weights and seed")
    mean_s = sum(step_s) / len(step_s)
    out = {"arch": cfg.name, "n_params": n_params, "layers": cfg.n_layers, "batch": batch,
           "seq": seq, "n_micro": n_micro, "steps": steps, "compress_ratio": 8,
           "remat": cfg.remat, "init_s": init_s, "warmup_step_s": run["warm_s"],
           "step_s": step_s, "step_ms_mean": mean_s * 1e3,
           "tokens_per_s": batch * seq / mean_s, "loss_warmup": run["warm_loss"],
           "losses": losses, "grad_norms": run["norms"], "compressor_ms": run["comp_ms"],
           "peak_memory_bytes": run["peak"], "peak_reserved_bytes": run["peak_reserved"],
           "launches": launches, "launches_per_step": {k: v / steps for k, v in launches.items()},
           "sketched_leaves": n_sk, "first_doc_ids": docs.tolist()}
    log(f"  {cfg.name}: {n_params:,} parameters ({cfg.n_layers} layers, d {cfg.d_model}), "
        f"global batch {batch} x {seq} drawn by the relational weights, n_micro {n_micro}, "
        f"remat {cfg.remat}, compression 8; init {init_s:.2f}s, warm-up step "
        f"{run['warm_s']:.2f}s (loss {run['warm_loss']:.4f}; doc ids {docs.tolist()} = the host "
        f"pipeline's)")
    log(f"  steps: {', '.join(f'{x * 1e3:.1f}' for x in step_s)} ms, mean {mean_s * 1e3:.1f} ms, "
        f"{out['tokens_per_s']:.0f} tokens/s; loss {', '.join(f'{x:.4f}' for x in losses)}; "
        f"grad norm {', '.join(f'{x:.3f}' for x in run['norms'])}")
    log(f"  compressor {', '.join(f'{x:.2f}' for x in run['comp_ms'])} ms a step (CUDA events); "
        f"peak memory {run['peak'] / 2 ** 30:.2f} GiB allocated, "
        f"{run['peak_reserved'] / 2 ** 30:.2f} reserved; launches {launches} "
        f"({out['launches_per_step']} a step)")
    if run["prof"] is not None:
        prof = out["profile_step"] = run["prof"]
        log(f"  profile one step: wall {prof['wall_ms']:.1f} ms, kernels busy "
            f"{prof['device_busy_ms']:.1f} ms, idle share {prof['idle_share']:.3f}; by kind "
            f"{prof['by_kind']}; top {prof['top']}")
    del tr, run
    gc.collect()
    torch.cuda.empty_cache()
    n_layers, n_micro_twin = 4, 2
    twin_sk = 20                      # every leaf of the stacked RWKV-6 model is sketched
    out["twin_f32"] = train_twin(
        "rwkv6_1_6b", (rwkv6, "rwkv6_chunk", rwkv6_chunk_ref),      # autograd through it
        ((wops, "launches"), (wops, "bwd_launches"), (cops, "launches")),
        (2 * n_layers * n_micro_twin, n_layers * n_micro_twin, twin_sk), dev,
        n_layers=n_layers, n_micro=n_micro_twin)
    return out


RWKV_STEPS = 2                     # phase 11(b)'s timed steps (cut from 4 for phase 20 (d)'s time)
HYMBA_TRAIN_KINDS = ("ssm_branch", "attention_bwd")    # record_function ranges, phase 14
HYMBA_STEPS = 1                    # phase 14's timed steps (cut from 4, then 2, for phase 20 (d)'s time)


def phase_hymba_train(fops, cops, other_ops, sketch_shapes, steps: int = 4, batch: int = 8,
                      seq: int = 2048, n_micro: int = 8, dev="cuda"):
    """Phase 14: Hymba-1.5B trained at full width and depth through
    ``launch/train.py``'s ``build`` (module docstring); ``sketch_shapes``
    are phase 1's count_sketch records, which must hold every (n, k) that
    the compressor sketches here."""
    from repro_torch.launch import train as T
    from repro_torch.tree import leaves

    args = T.parser().parse_args(["--arch", "hymba_1_5b", "--full", "--steps", str(steps + 1),
                                  "--batch", str(batch), "--seq", str(seq), "--n-micro",
                                  str(n_micro), "--compress-grads", "8", "--ckpt-every", "0",
                                  "--device", dev])
    t0 = time.perf_counter()
    tr = T.build(args)
    sync(dev)
    init_s = time.perf_counter() - t0
    cfg, comp = tr.model.cfg, tr.compressor
    n_windowed = sum(w is not None for w in tr.model.windows)
    sizes = [p.numel() for p in leaves(tr.params)]
    sketched = {(n, comp.sketch_size(n)) for n in sizes if n >= 4 * comp.ratio}
    n_sk = sum(n >= 4 * comp.ratio for n in sizes)
    missing = sketched - {(r["n"], r["k"]) for r in sketch_shapes}
    if missing:
        raise AssertionError(f"hymba train: phase 1 held count_sketch at no (n, k) of {missing}")
    run = run_steps(tr, n_micro, steps, (fops, cops, *other_ops), lambda: (
        {"flash_attention": fops.launches, "flash_attention_windowed": fops.windowed_launches,
         "count_sketch": cops.launches, "count_sketch_unsketch": cops.unsketch_launches},
        {o.__name__: o.launches for o in other_ops}), dev, True, TRAIN_KERNELS,
        HYMBA_TRAIN_KINDS)
    launches, others = run["counts"]
    losses, step_s, prof = run["losses"], run["step_s"], run["prof"]
    want = {"flash_attention": 2 * cfg.n_layers * n_micro * steps,
            "flash_attention_windowed": 2 * n_windowed * n_micro * steps,
            "count_sketch": n_sk * steps, "count_sketch_unsketch": n_sk * steps}
    if not all(math.isfinite(x) for x in losses + [run["warm_loss"]]):
        raise AssertionError(f"hymba train: a loss is not finite: {run['warm_loss']}, {losses}")
    if launches != want or any(others.values()):
        raise AssertionError(f"hymba train: launches {launches}, expected {want}; off the path "
                             f"{others}")
    mean_s = sum(step_s) / len(step_s)
    out = {"arch": cfg.name, "n_params": sum(sizes), "layers": cfg.n_layers,
           "windowed_layers": n_windowed, "meta_tokens": cfg.meta_tokens, "batch": batch,
           "seq": seq, "n_micro": n_micro, "steps": steps, "compress_ratio": comp.ratio,
           "remat": cfg.remat, "init_s": init_s, "warmup_step_s": run["warm_s"],
           "step_s": step_s, "step_ms_mean": mean_s * 1e3,
           "tokens_per_s": batch * seq / mean_s, "loss_warmup": run["warm_loss"],
           "losses": losses, "grad_norms": run["norms"], "compressor_ms": run["comp_ms"],
           "peak_memory_bytes": run["peak"], "peak_reserved_bytes": run["peak_reserved"],
           "launches": launches, "launches_per_step": {k: v / steps for k, v in launches.items()},
           "sketched_leaves": n_sk, "sketched_shapes": sorted(sketched), "profile_step": prof}
    log(f"  {cfg.name}: {sum(sizes):,} parameters ({cfg.n_layers} layers, {n_windowed} windowed, "
        f"d {cfg.d_model}, {cfg.meta_tokens} meta tokens), global batch {batch} x {seq} "
        f"(+{cfg.meta_tokens} meta positions a row), n_micro {n_micro}, remat {cfg.remat}, "
        f"compression {comp.ratio}; init {init_s:.2f}s, warm-up step {run['warm_s']:.2f}s "
        f"(loss {run['warm_loss']:.4f})")
    log(f"  steps: {', '.join(f'{x * 1e3:.1f}' for x in step_s)} ms, mean {mean_s * 1e3:.1f} ms, "
        f"{out['tokens_per_s']:.0f} tokens/s; loss {', '.join(f'{x:.4f}' for x in losses)}; "
        f"grad norm {', '.join(f'{x:.3f}' for x in run['norms'])}")
    log(f"  compressor {', '.join(f'{x:.2f}' for x in run['comp_ms'])} ms a step (CUDA events); "
        f"peak memory {run['peak'] / 2 ** 30:.2f} GiB allocated, "
        f"{run['peak_reserved'] / 2 ** 30:.2f} reserved; launches {launches} "
        f"({out['launches_per_step']} a step); {n_sk} leaves sketched")
    log(f"  profile one step: wall {prof['wall_ms']:.1f} ms, kernels busy "
        f"{prof['device_busy_ms']:.1f} ms ({prof['kernels']} kernels), idle share "
        f"{prof['idle_share']:.3f}; by kind {prof['by_kind']} (ssm_branch: its forward, remat "
        f"recompute and backward; attention_bwd: the plain windowed backward); top {prof['top']}")
    del tr, run
    gc.collect()
    torch.cuda.empty_cache()
    n_layers, n_micro_twin = 2, 2                  # layer 0 global, layer 1 windowed (1,024)
    twin_sk = 24                      # every leaf of the stacked 2-layer model is sketched
    out["twin_f32"] = train_twin(
        "hymba_1_5b", (fops, "flash_attention_gqa", plain_attention),
        ((fops, "launches"), (fops, "windowed_launches"), (cops, "launches")),
        (2 * n_layers * n_micro_twin, 2 * n_micro_twin, twin_sk), dev, n_layers=n_layers,
        n_micro=n_micro_twin)
    return out


# ----------------------------------------------------------------- phase 15 --
# (arch, layers on the card): each cut to 8 layers, as Llama-3-405B in phase 12
MOE_SERVE = (("dbrx_132b", 8), ("llama4_scout_17b_a16e", 8))


def moe_routing(model, params, tokens) -> dict:
    """One prefill of ``tokens`` with ``models/moe.route`` recorded: each
    layer's capacity, dropped (token, expert) pairs and tokens, and load
    (pairs an expert).  Raises where a pair was dropped: decode ≡ prefill(S
    + t) is meaningless there."""
    from repro_torch.models import moe
    from repro_torch.models.lm import SERVE_CAPACITY

    seen, route = [], moe.route

    def recording(*a, **kw):
        r = route(*a, **kw)
        seen.append(r)
        return r
    with swapped(moe, "route", recording):
        model.prefill(params, {"tokens": tokens})
    E = model.cfg.n_experts
    rec = {"capacity": [r.capacity for r in seen],
           "dropped_pairs": [int((~r.keep).sum()) for r in seen],
           "dropped_tokens": [int((~r.keep).view(r.expert.shape).any(1).sum()) for r in seen],
           "load": [torch.bincount(r.expert.reshape(-1), minlength=E).tolist() for r in seen]}
    log(f"  {model.cfg.name} ({model.cfg.dtype}, {tokens.shape[0]} x {tokens.shape[1]}) routing "
        f"at factor {SERVE_CAPACITY}: capacity {rec['capacity'][0]} a layer; tokens dropped by "
        f"layer {rec['dropped_tokens']}; experts' load (pairs an expert) by layer, min/max "
        f"{[(min(l), max(l)) for l in rec['load']]}; layer 0 {rec['load'][0]}")
    if any(rec["dropped_pairs"]):
        raise AssertionError(f"moe serve ({model.cfg.name}): the prefill at factor "
                             f"{SERVE_CAPACITY} dropped tokens {rec['dropped_tokens']} by layer, "
                             f"so decode against prefill(S + t) would be meaningless")
    return rec


# ------------------------------------------------------------- phases 16-19 --
def param_count(cfg) -> tuple:
    """(parameters, those of them float32 in a bf16 model: the routers,
    RWKV's w0 and u, the SSM's dt_bias, A_log and Dskip) of a config, from
    its widths alone."""
    D, N, Kh, dh, F = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_ff
    attn = 2 * D * N * dh + 2 * D * Kh * dh + ((N + 2 * Kh) * dh if cfg.qkv_bias else 0)
    mlp = (3 if cfg.act == "swiglu" else 2) * D * F
    ffn, f32 = mlp, 0
    if cfg.kind == "moe":
        f32 = D * cfg.n_experts
        ffn = f32 + 3 * cfg.n_experts * D * F + (3 * D * F if cfg.shared_expert else 0)
    block = attn + ffn + 2 * D
    if cfg.kind == "rwkv":          # six D×D, ck and cv, the decay's LoRA, 12 vectors of D
        f32 = 2 * D
        block = 6 * D * D + 2 * D * F + 2 * 64 * D + 12 * D
    if cfg.kind == "hybrid":        # the SSM (wx, wB, wC, wdt, wo, conv) and bn_a, bn_s
        H, d_inner = cfg.ssm_heads or N, N * dh
        f32 = 2 * H + d_inner
        block += 2 * D * d_inner + 2 * D * H * cfg.ssm_state + D * H + 4 * d_inner + f32 + 2 * D
    total = cfg.padded_vocab * D * (1 if cfg.tie_embeddings else 2) + D + cfg.meta_tokens * D
    total += cfg.n_layers * block
    if cfg.kind == "encdec":
        total += cfg.n_layers * (attn + D) + cfg.enc_layers * (attn + mlp + 2 * D) + D
    return total, f32 * cfg.n_layers


def reckon(tag: str, cfg, full_layers: int, train: bool, compress: bool = False) -> dict:
    """Logs, before a phase's run, its depth and the bytes its state takes
    on the card (weights; with ``train`` AdamW's float32 moments, the
    float32 gradient accumulators and, with ``compress``, the error
    feedback), against the card's memory.  Returns the record."""
    n, n32 = param_count(cfg)
    width = 2 if cfg.dtype == "bfloat16" else 4
    rec = {"layers": cfg.n_layers, "of_layers": full_layers, "n_params": n,
           "weights_bytes": (n - n32) * width + 4 * n32,
           "adamw_bytes": 8 * n if train else 0, "accumulator_bytes": 4 * n if train else 0,
           "error_feedback_bytes": 4 * n if compress else 0,
           "card_bytes": torch.cuda.get_device_properties(0).total_memory}
    rec["total_bytes"] = sum(rec[k] for k in ("weights_bytes", "adamw_bytes",
                                              "accumulator_bytes", "error_feedback_bytes"))
    log(f"  {tag} reckoning: {cfg.name} {cfg.n_layers} of {full_layers} layers"
        + (f" (+{cfg.enc_layers} encoder)" if cfg.kind == "encdec" else "")
        + f", {n / 1e9:.3f} B parameters; weights {rec['weights_bytes'] / 1e9:.2f} GB"
        + (f", AdamW {rec['adamw_bytes'] / 1e9:.2f} GB, accumulators "
           f"{rec['accumulator_bytes'] / 1e9:.2f} GB" if train else "")
        + (f", error feedback {rec['error_feedback_bytes'] / 1e9:.2f} GB" if compress else "")
        + f"; {rec['total_bytes'] / 1e9:.2f} GB of the card's {rec['card_bytes'] / 1e9:.2f} GB")
    return rec


class RouteLog:
    """A recording stand-in for ``models/moe.route`` (``moe.py``'s
    docstring allows one): each call's choices, keep mask and capacity,
    detached (a Routing's gates hold the step's graph)."""

    def __init__(self):
        from repro_torch.models import moe

        self.calls, self._route = [], moe.route

    def __call__(self, *a, **kw):
        r = self._route(*a, **kw)
        self.calls.append((r.expert.detach(), r.keep.detach(), r.capacity))
        return r

    def remat_mismatches(self, depth: int) -> tuple:
        """(differing (token, choice) pairs, pairs compared) between each
        block's forward routing and its recompute: a microbatch routes
        layers 0..L−1 forward, then L−1..0 in the backward's recomputes."""
        if len(self.calls) % (2 * depth):
            raise AssertionError(f"moe: {len(self.calls)} routings, not a whole number of "
                                 f"microbatches of {2 * depth}")
        bad = seen = 0
        for i in range(0, len(self.calls), 2 * depth):
            fwd, again = self.calls[i:i + depth], self.calls[i + depth:i + 2 * depth][::-1]
            for (e0, k0, _), (e1, k1, _) in zip(fwd, again):
                bad += int(((e0 != e1) | (k0 != k1).view(e0.shape)).sum())
                seen += e0.numel()
        return bad, seen

    def stats(self, depth: int, E: int) -> dict:
        """The forward routings' capacity, dropped pairs and tokens, and
        load (pairs an expert), by layer, over the calls recorded."""
        rec = {}
        for layer in range(depth):
            fwd = [c for i, c in enumerate(self.calls) if i % (2 * depth) == layer]
            rec[layer] = {
                "capacity": fwd[0][2], "microbatches": len(fwd),
                "dropped_pairs": sum(int((~k).sum()) for _, k, _ in fwd),
                "dropped_tokens": sum(int((~k).view(e.shape).any(1).sum()) for e, k, _ in fwd),
                "tokens": sum(e.shape[0] for e, _, _ in fwd),
                "load": torch.stack([torch.bincount(e.reshape(-1), minlength=E)
                                     for e, _, _ in fwd]).sum(0).tolist()}
        return rec


def moe_twin(fops, arch, dev="cuda", seq=2048):
    """Phase 16's float32 twin: ``arch`` at full width cut to 1 layer, one
    gradient stage (remat, 1 × ``seq`` tokens) served by the kernel and
    then by the plain attention with the same weights and batch; the plain
    run replays the kernel-served run's routing (``moe.route(...,
    expert=...)``: its own probabilities, the kernel run's choices), since
    float32 rounding of the two attentions may flip a top-k choice.  Loss
    within TRAIN_LOSS_RTOL relative, every gradient leaf within
    TRAIN_GRAD_RTOL · max|g|; prints the choices that would have differed
    untied."""
    from repro_torch import configs
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model, moe, stack_layers
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves, paths

    cfg = configs.get(arch).replace(dtype="float32", n_layers=1)
    model = Model(cfg, device=dev)
    params = stack_layers(model.init(torch.Generator(device=dev).manual_seed(0)))
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab, (1, seq))).to(dev)
    grads = make_train_step(model, adamw.AdamWConfig(), 1).grads
    rec_k = RouteLog()
    fops.reset_launches()
    with swapped(moe, "route", rec_k):
        g, loss_k = grads(params, {"tokens": toks})
    sync(dev)
    launches_k = fops.launches
    g_k = [t.cpu() for t in leaves(g)]              # the second run reuses the accumulators
    del g
    replay, untied, route = iter(rec_k.calls), [0, 0], rec_k._route

    def replaying(p, cfg_, xt, capacity_factor=None, dp=None):
        expert = next(replay)[0]
        with torch.no_grad():
            untied[0] += int((route(p, cfg_, xt, capacity_factor, dp=dp).expert != expert).sum())
        untied[1] += expert.numel()
        return route(p, cfg_, xt, capacity_factor, expert=expert, dp=dp)
    fops.reset_launches()
    with swapped(fops, "flash_attention_gqa", plain_attention), swapped(moe, "route", replaying):
        g, loss_p = grads(params, {"tokens": toks})
    sync(dev)
    launches_p = fops.launches
    loss_k, loss_p = float(loss_k), float(loss_p)
    rec = {"arch": cfg.name, "layers": 1, "seq": seq, "loss_kernel": loss_k,
           "loss_plain": loss_p, "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
           "choices_differing_untied": untied[0], "choices": untied[1],
           "launches_kernel": launches_k, "launches_plain": launches_p, "leaves": {}}
    ok = rec["loss_rel_diff"] <= TRAIN_LOSS_RTOL and math.isfinite(loss_k)
    for name, gk, gp in zip(paths(params), g_k, leaves(g)):
        rel = float((gk.to(dev) - gp).abs().max() / gp.abs().max())
        rec["leaves"][name] = rel
        ok &= rel <= TRAIN_GRAD_RTOL
    log(f"  float32 twin ({cfg.name}, 1 layer, 1 x {seq}, remat): loss kernel {loss_k:.7f} "
        f"plain {loss_p:.7f} (rel {rec['loss_rel_diff']:.2e}); per leaf max |Δg|/max|g| "
        f"{max(rec['leaves'].values()):.2e}; routing replayed: {untied[0]} of {untied[1]} "
        f"choices would have differed untied; flash_attention launches {launches_k} (kernel) "
        f"and {launches_p} (plain)")
    if not (ok and launches_k == 2 and launches_p == 0):
        raise AssertionError(f"moe twin: kernel- and plain-served gradients disagree: {rec}")
    del model, params, g, g_k
    gc.collect()
    torch.cuda.empty_cache()
    return rec


MOE_TRAIN = ("dbrx_132b", "llama4_scout_17b_a16e")
MOE_TRAIN_KINDS = ("moe_experts", "attention_bwd")   # record_function ranges, phase 16


def phase_moe_train(fops, other_ops, arch, depth: int = 1, steps: int = 4, batch: int = 8,
                    seq: int = 2048, n_micro: int = 8, dev="cuda"):
    """Phase 16: ``arch`` trained at full width cut to ``depth`` layers
    through ``launch/train.py``'s ``build`` (module docstring), no
    compressor, every routing recorded; then its float32 twin."""
    from repro_torch import configs
    from repro_torch.launch import train as T
    from repro_torch.models import moe
    from repro_torch.tree import leaves

    full = configs.get(arch)
    plan = reckon("phase 16", full.replace(n_layers=depth), full.n_layers, train=True)
    args = T.parser().parse_args(["--arch", arch, "--full", "--layers", str(depth), "--steps",
                                  str(steps + 1), "--batch", str(batch), "--seq", str(seq),
                                  "--n-micro", str(n_micro), "--ckpt-every", "0",
                                  "--device", dev])
    t0 = time.perf_counter()
    tr = T.build(args)
    sync(dev)
    init_s = time.perf_counter() - t0
    cfg = tr.model.cfg
    routes = RouteLog()
    with swapped(moe, "route", routes):
        run = run_steps(tr, n_micro, steps, (fops, *other_ops), lambda: (
            {"flash_attention": fops.launches},
            {o.__name__: o.launches for o in other_ops}), dev, True, TRAIN_KERNELS,
            MOE_TRAIN_KINDS)
    launches, others = run["counts"]
    losses, step_s, prof = run["losses"], run["step_s"], run["prof"]
    want = {"flash_attention": 2 * depth * n_micro * steps}
    if not all(math.isfinite(x) for x in losses + [run["warm_loss"]]):
        raise AssertionError(f"moe train ({cfg.name}): a loss is not finite: "
                             f"{run['warm_loss']}, {losses}")
    if launches != want or any(others.values()):
        raise AssertionError(f"moe train ({cfg.name}): launches {launches}, expected {want}; "
                             f"off the path {others}")
    bad, compared = routes.remat_mismatches(depth)
    if bad:
        raise AssertionError(f"moe train ({cfg.name}): the remat recompute routed {bad} of "
                             f"{compared} (token, choice) pairs otherwise than its forward")
    routing = routes.stats(depth, cfg.n_experts)
    del routes
    mean_s = sum(step_s) / len(step_s)
    out = {"arch": cfg.name, "n_params": sum(p.numel() for p in leaves(tr.params)),
           "layers": depth, "of_layers": full.n_layers, "batch": batch, "seq": seq,
           "n_micro": n_micro, "steps": steps, "capacity_factor": cfg.capacity_factor,
           "remat": cfg.remat, "init_s": init_s, "warmup_step_s": run["warm_s"],
           "step_s": step_s, "step_ms_mean": mean_s * 1e3, "tokens_per_s": batch * seq / mean_s,
           "loss_warmup": run["warm_loss"], "losses": losses, "grad_norms": run["norms"],
           "peak_memory_bytes": run["peak"], "peak_reserved_bytes": run["peak_reserved"],
           "launches": launches, "launches_per_step": {k: v / steps for k, v in launches.items()},
           "remat_routing_mismatches": bad, "remat_routing_pairs": compared,
           "routing_by_layer": routing, "reckoning": plan, "profile_step": prof}
    log(f"  {cfg.name}: {out['n_params']:,} parameters ({depth} of {full.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.n_experts} experts top {cfg.top_k}, capacity factor "
        f"{cfg.capacity_factor}), global batch {batch} x {seq}, n_micro {n_micro}, remat; init "
        f"{init_s:.2f}s, warm-up step {run['warm_s']:.2f}s (loss {run['warm_loss']:.4f})")
    log(f"  steps: {', '.join(f'{x * 1e3:.1f}' for x in step_s)} ms, mean {mean_s * 1e3:.1f} ms, "
        f"{out['tokens_per_s']:.0f} tokens/s; loss {', '.join(f'{x:.4f}' for x in losses)}; "
        f"peak memory {run['peak'] / 2 ** 30:.2f} GiB allocated, "
        f"{run['peak_reserved'] / 2 ** 30:.2f} reserved; launches {launches}")
    for layer, r in routing.items():
        log(f"  routing layer {layer} (every microbatch of every step, the forward's): capacity "
            f"{r['capacity']} a microbatch; {r['dropped_pairs']} (token, expert) pairs and "
            f"{r['dropped_tokens']} of {r['tokens']} tokens dropped; load min/max "
            f"{min(r['load'])}/{max(r['load'])}: {r['load']}")
    log(f"  remat: the recompute routed as its forward on all {compared} (token, choice) pairs")
    log(f"  profile one step: wall {prof['wall_ms']:.1f} ms, kernels busy "
        f"{prof['device_busy_ms']:.1f} ms ({prof['kernels']} kernels), idle share "
        f"{prof['idle_share']:.3f}; by kind {prof['by_kind']}; top {prof['top']}")
    del tr, run
    gc.collect()
    torch.cuda.empty_cache()
    out["twin_f32"] = moe_twin(fops, arch, dev, seq)
    return out


ENCDEC = "seamless_m4t_medium"


def phase_encdec_train(fops, cops, other_ops, steps: int = 4, batch: int = 8, seq: int = 2048,
                       n_micro: int = 8, dev="cuda"):
    """Phase 18: seamless-M4T-medium trained at full width and depth through
    ``launch/train.py``'s ``build``: each row ``seq``/2 frames and
    ``seq``/2 tokens (module docstring)."""
    from repro_torch import configs
    from repro_torch.launch import train as T
    from repro_torch.tree import leaves

    full = configs.get(ENCDEC)
    plan = reckon("phase 18", full, full.n_layers, train=True, compress=True)
    args = T.parser().parse_args(["--arch", ENCDEC, "--full", "--steps", str(steps + 1),
                                  "--batch", str(batch), "--seq", str(seq), "--n-micro",
                                  str(n_micro), "--compress-grads", "8", "--ckpt-every", "0",
                                  "--device", dev])
    t0 = time.perf_counter()
    tr = T.build(args)
    sync(dev)
    init_s = time.perf_counter() - t0
    cfg, comp = tr.model.cfg, tr.compressor
    sizes = [p.numel() for p in leaves(tr.params)]
    n_sk = sum(n >= 4 * comp.ratio for n in sizes)
    if max(sizes) > 2 ** 31 - 1:
        raise AssertionError(f"encdec train: a leaf of {max(sizes)} elements passes the "
                             f"count_sketch kernel's limit")
    run = run_steps(tr, n_micro, steps, (fops, cops, *other_ops), lambda: (
        {"flash_attention": fops.launches, "flash_attention_noncausal": fops.noncausal_launches,
         "count_sketch": cops.launches, "count_sketch_unsketch": cops.unsketch_launches},
        {o.__name__: o.launches for o in other_ops}), dev, True, TRAIN_KERNELS,
        ("attention_bwd",))
    launches, others = run["counts"]
    losses, step_s, prof = run["losses"], run["step_s"], run["prof"]
    per_fwd = cfg.enc_layers + 2 * cfg.n_layers            # encoder, self- and cross-attention
    want = {"flash_attention": 2 * per_fwd * n_micro * steps,
            "flash_attention_noncausal": 2 * (cfg.enc_layers + cfg.n_layers) * n_micro * steps,
            "count_sketch": n_sk * steps, "count_sketch_unsketch": n_sk * steps}
    if not all(math.isfinite(x) for x in losses + [run["warm_loss"]]):
        raise AssertionError(f"encdec train: a loss is not finite: {run['warm_loss']}, {losses}")
    if launches != want or any(others.values()):
        raise AssertionError(f"encdec train: launches {launches}, expected {want}; off the path "
                             f"{others}")
    mean_s = sum(step_s) / len(step_s)
    out = {"arch": cfg.name, "n_params": sum(sizes), "layers": cfg.n_layers,
           "enc_layers": cfg.enc_layers, "batch": batch, "frames": seq // 2,
           "tokens": seq // 2, "n_micro": n_micro, "steps": steps, "compress_ratio": comp.ratio,
           "remat": cfg.remat, "init_s": init_s, "warmup_step_s": run["warm_s"],
           "step_s": step_s, "step_ms_mean": mean_s * 1e3, "tokens_per_s": batch * seq / mean_s,
           "loss_warmup": run["warm_loss"], "losses": losses, "grad_norms": run["norms"],
           "compressor_ms": run["comp_ms"], "peak_memory_bytes": run["peak"],
           "peak_reserved_bytes": run["peak_reserved"], "launches": launches,
           "launches_per_step": {k: v / steps for k, v in launches.items()},
           "sketched_leaves": n_sk, "largest_leaf": max(sizes), "reckoning": plan,
           "profile_step": prof}
    log(f"  {cfg.name}: {sum(sizes):,} parameters ({cfg.enc_layers} encoder and {cfg.n_layers} "
        f"decoder layers, d {cfg.d_model}), global batch {batch} x ({seq // 2} frames + "
        f"{seq // 2} tokens), n_micro {n_micro}, remat, compression {comp.ratio}; init "
        f"{init_s:.2f}s, warm-up step {run['warm_s']:.2f}s (loss {run['warm_loss']:.4f})")
    log(f"  steps: {', '.join(f'{x * 1e3:.1f}' for x in step_s)} ms, mean {mean_s * 1e3:.1f} ms, "
        f"{out['tokens_per_s']:.0f} positions/s; loss {', '.join(f'{x:.4f}' for x in losses)}")
    log(f"  compressor {', '.join(f'{x:.2f}' for x in run['comp_ms'])} ms a step (CUDA events); "
        f"peak memory {run['peak'] / 2 ** 30:.2f} GiB allocated, "
        f"{run['peak_reserved'] / 2 ** 30:.2f} reserved; launches {launches} "
        f"({out['launches_per_step']} a step); {n_sk} leaves sketched, the largest "
        f"{max(sizes):,} elements")
    log(f"  profile one step: wall {prof['wall_ms']:.1f} ms, kernels busy "
        f"{prof['device_busy_ms']:.1f} ms ({prof['kernels']} kernels), idle share "
        f"{prof['idle_share']:.3f}; by kind {prof['by_kind']}; top {prof['top']}")
    del tr, run
    gc.collect()
    torch.cuda.empty_cache()
    layers, n_micro_twin = 2, 2
    twin_sk = 25                      # every leaf of the stacked 2 + 2-layer model is sketched
    out["twin_f32"] = train_twin(
        ENCDEC, (fops, "flash_attention_gqa", plain_attention),
        ((fops, "launches"), (fops, "noncausal_launches"), (cops, "launches")),
        (2 * 3 * layers * n_micro_twin, 2 * 2 * layers * n_micro_twin, twin_sk), dev,
        n_layers=layers, n_micro=n_micro_twin, enc_layers=layers)
    return out


def serve_depth(arch: str, batch: int, prompt: int) -> tuple:
    """The depth phase 19 serves ``arch`` at: the config's, unless its
    reckoned weights and 8 GiB for the prefill, the cache and the gates
    pass the card's memory, then the most layers that fit.  Returns (the
    config, the reckoning)."""
    from repro_torch import configs

    full = configs.get(arch)
    plan = reckon("phase 19", full, full.n_layers, train=False)
    room = plan["card_bytes"] - 8 * 2 ** 30
    if plan["weights_bytes"] <= room:
        return full, plan
    per_layer = (param_count(full.replace(n_layers=2))[0]
                 - param_count(full.replace(n_layers=1))[0]) * 2
    depth = int((room - (plan["weights_bytes"] - full.n_layers * per_layer)) // per_layer)
    cut = full.replace(n_layers=depth)
    log(f"  phase 19: the card cannot hold {full.n_layers} layers; cut to {depth}")
    return cut, reckon("phase 19", cut, full.n_layers, train=False)


# ----------------------------------------------------------------- phase 12 --
# (arch, batch, layers on the card: None keeps the config's depth)
DENSE_SERVE = (("granite_3_8b", 8, None), ("qwen2_5_32b", 1, None), ("llama3_405b", 1, 8))


def host_state(tag: str) -> dict:
    """What the phases before ``tag`` leave in this process: threads,
    Python objects after a full collection, obs metrics, tracing, CUDA
    memory allocated and reserved.  Logged; returns the record."""
    from repro_torch.obs import get_registry, tracing_enabled

    gc.collect()
    rec = {"threads": threading.active_count(), "gc_objects": len(gc.get_objects()),
           "metrics": len(get_registry().names()), "tracing": tracing_enabled(),
           "allocated_gib": torch.cuda.memory_allocated() / 2 ** 30,
           "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30}
    log(f"  host state before {tag}: {rec}")
    return rec


# ----------------------------------------------------------------- phase 20 --
PLACED_ARGS = ("--arch", "tinyllama_1_1b", "--full", "--layers", "4", "--steps", "2", "--batch",
               "8", "--seq", "2048", "--n-micro", "8", "--compress-grads", "8", "--ckpt-every",
               "0", "--log-every", "1")           # 4 of 22 layers: cut for phase 20 (d)'s time
DRYRUN_CELLS = (("tinyllama_1_1b", "train_4k", "16x16"), ("llama3_405b", "decode_32k", "2x16x16"),
                ("dbrx_132b", "prefill_32k", "16x16"), ("rwkv6_1_6b", "train_4k", "16x16"),
                ("hymba_1_5b", "train_4k", "16x16"), ("seamless_m4t_medium", "train_4k", "16x16"))
# cells also run on the gathered path (no tp context: each block's weights gathered whole, the
# ranks of a tp group computing the same rows), with the FLOPs a rank the tp path must stay
# below as a share of it
DRYRUN_GATHERED = {("hymba_1_5b", "train_4k", "16x16"): 1.0,
                   ("seamless_m4t_medium", "train_4k", "16x16"): 1 / 8}
# cells also run on a mesh with one dp rank at the same tp, whose FLOPs a rank, over the cell's
# dp, they must not exceed: an MoE rank's expert buffer holds its own tokens' pairs alone
DRYRUN_DP_ONE = {("dbrx_132b", "prefill_32k", "16x16"): "1x16"}
DRYRUN_DP_RTOL = 1e-3
_GATHERED_CELL = ("import sys; from repro_torch.distributed import tp; "
                  "tp.context = lambda mesh, cfg: None; from repro_torch.launch import dryrun; "
                  "sys.exit(dryrun.main(sys.argv[1:]))")
DRYRUN_TIMEOUT_S = 300
PLACED_APART = 1e-5                # placed vs plain parameters: the share of elements apart


def rule_bytes(arch: str, shape_name: str, tag: str) -> dict:
    """A dry-run cell's argument bytes a rank holds, summed here from the
    placement rules on an abstract mesh of the cell's shape (no process
    group): the parameters (built on ``meta``), for training AdamW's step,
    moments and the batch, for a prefill the batch, for decode the cache
    and the tokens; and how many parameter leaves the rules shard."""
    from repro_torch import configs
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import Model, stack_layers
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves

    shape, names = dryrun.mesh_spec(tag)
    mesh, sizes = S.AbstractMesh(shape, names), dict(zip(names, shape))

    def local(tree, shard):
        total = 0
        for t, sh in zip(leaves(tree), leaves(shard)):
            n = t.element_size()
            for i, d in enumerate(t.shape):
                e = sh.spec[i] if i < len(sh.spec) else None
                n *= d // math.prod(sizes[a] for a in (() if e is None else
                                                        e if isinstance(e, tuple) else (e,)))
            total += n
        return total

    with dryrun.OnMeta():
        params = stack_layers(Model(configs.get(arch), device="meta").init(torch.Generator()))
    pshard = S.param_shardings(mesh, params)
    total = local(params, pshard)
    mode, specs = steps.input_specs(arch, shape_name)
    if mode == "train":
        opt = adamw.init(adamw.AdamWConfig(), params)
        total += 4 + local(opt.m, pshard) + local(opt.v, pshard)
    if mode in ("train", "prefill"):
        total += local(specs["batch"], S.batch_shardings(mesh, specs["batch"]))
    else:
        total += local(specs["cache"], S.cache_shardings(mesh, specs["cache"]))
        total += local(specs["tokens"], S.batch_shardings(mesh, specs["tokens"]))
    return {"arguments": total,
            "sharded_leaves": sum(any(e is not None for e in sh.spec) for sh in leaves(pshard))}


def dryrun_start() -> tuple:
    """Start phase 20 (c)'s cells, each of ``DRYRUN_CELLS`` through
    ``launch/dryrun.py``'s CLI in a subprocess of its own (a fake process
    group of 256 or 512 ranks, within ``DRYRUN_TIMEOUT_S``), side by side,
    and each of ``DRYRUN_GATHERED`` again with ``tp.context`` returning
    None (the gathered path: no tensor parallelism), and each of
    ``DRYRUN_DP_ONE`` again on its mesh of one dp rank.
    They need no card, so ``main`` starts them before phase 1 and
    :func:`dryrun_cells` collects them; the processes and their directory
    go when this process exits.  Returns (directory, processes, start)."""
    import atexit
    import os
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    os.makedirs(Path(tmp) / "gathered")
    os.makedirs(Path(tmp) / "dp1")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = []
    for arch, shape_name, tag in DRYRUN_CELLS:
        with open(Path(tmp) / f"{arch}__{shape_name}__{tag}.out", "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
                 shape_name, "--mesh", "single" if tag == "16x16" else "multi", "--out", tmp,
                 "--timeout", str(DRYRUN_TIMEOUT_S)], stdout=out, stderr=subprocess.STDOUT,
                env=env))
    for arch, shape_name, tag in DRYRUN_GATHERED:       # the cell itself, in this process
        with open(Path(tmp) / "gathered" / f"{arch}__{shape_name}__{tag}.out", "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _GATHERED_CELL, "--out", str(Path(tmp) / "gathered"),
                 "--cell", arch, shape_name, tag], stdout=out, stderr=subprocess.STDOUT,
                env=env))
    for (arch, shape_name, _), tag in DRYRUN_DP_ONE.items():
        with open(Path(tmp) / "dp1" / f"{arch}__{shape_name}__{tag}.out", "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--out", str(Path(tmp) / "dp1"),
                 "--cell", arch, shape_name, tag], stdout=out, stderr=subprocess.STDOUT,
                env=env))

    def stop():
        for proc in procs:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    atexit.register(stop)
    return tmp, procs, time.perf_counter()


def dryrun_cells(started: tuple) -> list:
    """Phase 20 (c): the cells :func:`dryrun_start` started, each record's
    ``arguments`` against the rules' sum, and on a training cell at least
    one all-gather a sharded leaf a microbatch; a cell of
    ``DRYRUN_GATHERED``'s FLOPs a rank at most its share of the gathered
    path's, its peak live bytes beside; a cell of ``DRYRUN_DP_ONE``'s FLOPs
    a rank, times its dp, at most (1 + ``DRYRUN_DP_RTOL``) times those of
    its mesh of one dp rank (they do not grow with dp)."""
    from repro_torch.launch import steps

    tmp, procs, t0 = started
    done = [(proc.wait(timeout=DRYRUN_TIMEOUT_S + 60), time.perf_counter() - t0)
            for proc in procs]
    cells = ([(c, Path(tmp)) for c in DRYRUN_CELLS]
             + [(c, Path(tmp) / "gathered") for c in DRYRUN_GATHERED]
             + [((a, s, t), Path(tmp) / "dp1") for (a, s, _), t in DRYRUN_DP_ONE.items()])
    out, gathered, dp1 = [], {}, {}
    for ((arch, shape_name, tag), where), (rc, wall) in zip(cells, done):
        path = where / f"{arch}__{shape_name}__{tag}.json"
        if rc != 0 or not path.exists():
            err = path.with_name(path.name + ".err")
            raise AssertionError(f"dry run {arch} {shape_name} {tag}: exit {rc}, "
                                 f"{path.with_suffix('.out').read_text()[-3000:]} "
                                 f"{err.read_text()[-3000:] if err.exists() else ''}")
        rec = json.loads(path.read_text())
        if where.name == "gathered":
            gathered[arch, shape_name, tag] = rec
            continue
        if where.name == "dp1":
            dp1[arch, shape_name] = rec
            continue
        want = rule_bytes(arch, shape_name, tag)
        b, census, cost = rec["per_device_bytes"], rec["collectives"], rec["cost_analysis"]
        log(f"  dry run {arch} x {shape_name} x {tag} ({rec['world']} fake ranks): arguments "
            f"{b['arguments']:,} B a rank (the rules' sum {want['arguments']:,}), outputs "
            f"{b['outputs']:,} B, peak live {b['peak_live'] / 2 ** 30:.2f} GiB; flops a rank "
            f"{cost['flops_per_device']:.4e} (ATen {cost['aten_flops']:.4e}, kernels "
            f"{cost['kernel_operations']}); census "
            f"{ {k: v for k, v in census.items() if v['count']} }; lower_s "
            f"{rec['lower_s']:.1f}, collected {wall:.1f}s after its start")
        if b["arguments"] != want["arguments"]:
            raise AssertionError(f"dry run {arch} {shape_name} {tag}: arguments "
                                 f"{b['arguments']} against the rules' {want['arguments']}")
        if shape_name == "train_4k":
            dp = math.prod(int(x) for x in tag.split("x")[:-1])
            need = want["sharded_leaves"] * steps.n_micro(arch, 256, dp)
            if census["all-gather"]["count"] < need:
                raise AssertionError(f"dry run {arch} {tag}: {census['all-gather']['count']} "
                                     f"all-gathers, fewer than one a sharded leaf "
                                     f"({want['sharded_leaves']}) a microbatch ({need})")
        out.append({**rec, "rules": want, "subprocess_s": wall})
    for rec in out:
        cell = (rec["arch"], rec["shape"], rec["mesh"])
        if cell in DRYRUN_DP_ONE:
            one = dp1[cell[:2]]
            dp = math.prod(int(x) for x in cell[2].split("x")[:-1])
            flops, one_flops = (r["cost_analysis"]["flops_per_device"] for r in (rec, one))
            rec["dp_one"] = {k: one[k] for k in ("mesh", "per_device_bytes", "cost_analysis",
                                                  "lower_s")}
            log(f"  dry run {' x '.join(cell)} against {one['mesh']} (one dp rank): flops a rank "
                f"x dp {flops * dp:.4e} / {one_flops:.4e} = {flops * dp / one_flops:.6f} (limit "
                f"{1 + DRYRUN_DP_RTOL}), peak live "
                f"{rec['per_device_bytes']['peak_live'] / 2 ** 30:.2f} / "
                f"{one['per_device_bytes']['peak_live'] / 2 ** 30:.2f} GiB")
            if not flops * dp <= (1 + DRYRUN_DP_RTOL) * one_flops:
                raise AssertionError(f"dry run {cell}: flops a rank {flops} times dp {dp} above "
                                     f"{one['mesh']}'s {one_flops}: they grow with dp")
        if cell not in gathered:
            continue
        g = gathered[cell]
        flops, g_flops = (r["cost_analysis"]["flops_per_device"] for r in (rec, g))
        peak, g_peak = (r["per_device_bytes"]["peak_live"] for r in (rec, g))
        rec["gathered_path"] = {k: g[k] for k in ("per_device_bytes", "cost_analysis",
                                                   "collectives", "lower_s")}
        log(f"  dry run {' x '.join(cell)} against the gathered path (no tp context): flops a "
            f"rank {flops:.4e} / {g_flops:.4e} = {flops / g_flops:.4f} (limit "
            f"{DRYRUN_GATHERED[cell]:.4f}), peak live {peak / 2 ** 30:.2f} / "
            f"{g_peak / 2 ** 30:.2f} GiB, census "
            f"{ {k: v['count'] for k, v in rec['collectives'].items() if v['count']} } / "
            f"{ {k: v['count'] for k, v in g['collectives'].items() if v['count']} }, lower_s "
            f"{rec['lower_s']:.1f} / {g['lower_s']:.1f}")
        if not flops < DRYRUN_GATHERED[cell] * g_flops:
            raise AssertionError(f"dry run {cell}: flops a rank {flops} not below "
                                 f"{DRYRUN_GATHERED[cell]} of the gathered path's {g_flops}")
    return out


def phase_placed(fops, cops, other_ops, dev="cuda", argv=PLACED_ARGS) -> dict:
    """Phase 20 (a) and (b): TinyLlama-1.1B trained by ``launch/train.py``'s
    ``run`` (what ``main`` runs) on ``make_host_mesh()``, (1, 1) on one
    card, its last blocking checkpoint the state's save, after the plain
    trainer twice on the same seed and batches; then that checkpoint
    restored by ``restore_elastic`` onto ``rebuild_mesh(1)``.  Losses and
    grad norms must be bit-equal to both plain runs'.  The parameters are
    held to the first plain run's, not bit for bit: at most a share
    ``PLACED_APART`` of the elements apart, each by at most the 2·lr a step
    that two AdamW updates can differ by (plus a bf16 rounding flip).  The
    count_sketch kernel adds into a bucket with atomics, so a compressed
    gradient's last float32 bits change from run to run, and AdamW's first
    steps, g/(|g| + 1e-8), turn that into up to lr where a compressed g is
    a few 1e-8; the second plain run shows that spread beside the placed
    one, under the same gate.  Leaves the process group it joined."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as T
    from repro_torch.runtime import elastic
    from repro_torch.tree import leaves

    tmp = tempfile.mkdtemp(prefix="chip_smoke_placed_")
    joined = M.join_world(dev)
    try:
        args = T.parser().parse_args([*argv, "--device", dev, "--ckpt-dir", tmp])

        def plain_run():
            held = torch.cuda.memory_allocated()        # what earlier runs keep for the checks
            torch.cuda.reset_peak_memory_stats()
            plain, hist = T.build(args), []
            try:
                for _ in range(args.steps):
                    b = plain.next_batch()
                    t0 = time.perf_counter()
                    m = plain.step(b)
                    hist.append({"s": time.perf_counter() - t0,
                                 **{k: float(v) for k, v in m.items()}})
            finally:
                plain.pipe.stop()
            hist[-1]["peak"] = torch.cuda.max_memory_allocated() - held
            return leaves(plain.params), hist
        plain_params, plain_hist = plain_run()            # the first warms the card up
        gc.collect()
        torch.cuda.empty_cache()
        again_params, again_hist = plain_run()
        gc.collect()
        torch.cuda.empty_cache()
        mesh = M.make_host_mesh(dev)
        held = torch.cuda.memory_allocated()            # the plain runs' weights, kept
        torch.cuda.reset_peak_memory_stats()
        for o in (fops, cops, *other_ops):                              # main path starts here
            o.reset_launches()
        t0 = time.perf_counter()
        tr = T.run(args, mesh)
        launches = {"flash_attention": fops.launches, "count_sketch": cops.launches,
                    "count_sketch_unsketch": cops.unsketch_launches}
        others = {o.__name__: o.launches for o in other_ops}           # ... and ends here
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - held
        n_layers = tr.model.cfg.n_layers
        sketched = sum(p.numel() >= 4 * args.compress_grads for p in leaves(tr.params))
        want = {"flash_attention": 2 * n_layers * args.n_micro * args.steps,   # 352 a step
                "count_sketch": sketched * args.steps,                         # 12 a step
                "count_sketch_unsketch": sketched * args.steps}
        if launches != want or any(others.values()):
            raise AssertionError(f"placed train: launches {launches}, expected {want}; off the "
                                 f"path {others}")
        same = {k: [h[k] for h in tr.history] == [h[k] for h in plain_hist]
                == [h[k] for h in again_hist] for k in ("loss", "grad_norm")}

        lr_sum = sum(h["lr"] for h in plain_hist)

        def spread(params):                # (elements apart, of all; the most |Δp| / its bound)
            apart, worst, n = 0, 0.0, 0
            for a, b in zip(params, plain_params):
                d = (a.float() - b.float()).abs()
                apart += int((d > 0).sum())
                n += d.numel()
                worst = max(worst, float((d / (2 * lr_sum + 2.0 ** -7 * b.float().abs())).max()))
            return apart / n, worst
        placed_spread = spread([t.to_local() for t in leaves(tr.params)])
        plain_spread = spread(again_params)
        same["params"] = placed_spread[0] == 0
        del plain_params, again_params
        tokens = args.batch * args.seq
        step_ms = [h["s"] * 1e3 for h in tr.history]
        plain_ms = [h["s"] * 1e3 for h in again_hist]
        step_dir = Path(tmp) / f"step_{args.steps}"
        out = {"arch": "tinyllama_1_1b", "mesh": list(mesh.shape), "batch": args.batch,
               "seq": args.seq, "n_micro": args.n_micro, "steps": args.steps,
               "step_ms": step_ms, "plain_step_ms": plain_ms,
               "tokens_per_s": [tokens / h["s"] for h in tr.history],
               "plain_tokens_per_s": [tokens / h["s"] for h in plain_hist],
               "overhead_ms": [a - b for a, b in zip(step_ms, plain_ms)],
               "losses": [h["loss"] for h in tr.history],
               "plain_losses": [h["loss"] for h in plain_hist],
               "grad_norms": [h["grad_norm"] for h in tr.history],
               "first_plain_step_ms": [h["s"] * 1e3 for h in plain_hist],
               "bit_equal": same, "params_apart_share": placed_spread[0],
               "params_worst_of_bound": placed_spread[1],
               "plain_rerun_apart_share": plain_spread[0],
               "plain_rerun_worst_of_bound": plain_spread[1], "launches": launches,
               "run_s": run_s,
               "peak_memory_gib": peak / 2 ** 30,
               "plain_peak_memory_gib": again_hist[-1]["peak"] / 2 ** 30,
               "checkpoint_bytes": sum(f.stat().st_size for f in step_dir.iterdir())}
        log(f"  placed (mesh {tuple(mesh.shape)}): steps {', '.join(f'{x:.1f}' for x in step_ms)} "
            f"ms against the plain trainer's second run's "
            f"{', '.join(f'{x:.1f}' for x in plain_ms)} "
            f"ms (overhead {', '.join(f'{x:+.1f}' for x in out['overhead_ms'])} ms; its first "
            f"run's {', '.join(f'{x:.1f}' for x in out['first_plain_step_ms'])} ms warmed the "
            f"card), {out['tokens_per_s'][-1]:.0f} tokens/s at the last step; losses "
            f"{out['losses']} against {out['plain_losses']}; bit-equal {same}; parameters apart "
            f"{placed_spread[0]:.3e} of the elements, the most |Δp| {placed_spread[1]:.3f} of "
            f"2·Σlr + a bf16 flip (the plain rerun's {plain_spread[0]:.3e}, "
            f"{plain_spread[1]:.3f}: "
            f"the count_sketch kernel's atomic sums); launches {launches}; peak "
            f"{out['peak_memory_gib']:.2f} GiB allocated (the plain run's "
            f"{out['plain_peak_memory_gib']:.2f}; each run's own, from its build on); run "
            f"{run_s:.1f}s with its {out['checkpoint_bytes'] / 1e9:.2f} GB blocking save")
        if not (same["loss"] and same["grad_norm"]) or any(
                a > PLACED_APART or w > 1.0 for a, w in (placed_spread, plain_spread)):
            raise AssertionError(f"placed train: the placed and plain steps differ: {same}, "
                                 f"parameters {placed_spread} (plain rerun {plain_spread})")
        mesh1 = elastic.rebuild_mesh(1, dev)
        t0 = time.perf_counter()
        back = elastic.restore_elastic(Checkpointer(tmp), args.steps, tr.state(), mesh1,
                                       T.state_shardings)
        torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        pairs = list(zip(leaves(back), leaves(tr.state())))
        exact = all(
            (isinstance(a, DTensor) and a.device_mesh == mesh1 and a.placements == b.placements
             and torch.equal(a.to_local(), b.to_local())) if isinstance(b, DTensor)
            else torch.equal(a, b) for a, b in pairs)
        out["restore_bit_equal"] = exact
        log(f"  elastic restore onto rebuild_mesh(1) {tuple(mesh1.shape)}: {len(pairs)} leaves in "
            f"{out['restore_s']:.1f}s, bit for bit {exact}")
        if not exact:
            raise AssertionError("placed train: the elastic restore is not bit for bit")
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if joined:
            dist.destroy_process_group()


# ------------------------------------------------------------- phase 20 (d) --
TP_WORLD = 2                       # ranks sharing the one card over gloo: a (1, 2) mesh
TP_TIMEOUT_S = 900.0               # every rank joined within this, or the phase fails
TP_STEPS, TP_DECODE = 2, 16        # bf16 steps of a trained part, decode steps of a served one
TP_LOSS_RTOL = 1e-2                # bf16 step 1 against the plain trainer's
TP_NOISE = 2.0                     # logits: within this times the plain bf16 model's distance
# Phase 20 (d)'s configurations, each at its full width: its float32 twin (layers, batch,
# seq; None: none), its bf16 steps (layers, batch, seq, microbatches, compression; None: not
# trained) and its serve (layers, batch, prompt).  An encoder-decoder's layers count its
# encoder's too, and its seq and prompt are half frames, half tokens; Hymba's add its 128
# meta positions.  TinyLlama cut from 22 layers to 2 (its twin from 4 to 2 layers, then from 2
# rows to 1) for the time the MoE, RWKV, hybrid and encoder-decoder parts and the (2, 1) part
# take; DBRX trained on 1 layer (its state at 40
# would not fit), the MoE LMs served on 2 (the stream crosses a block boundary), RWKV-6 on 4
# of 24; Hymba trained on 2 of 32 (one global layer, one windowed) and served on 4 (one
# global), seamless on 2 + 2 and 4 + 4 of 12 + 12, trained uncompressed (the sketch would
# gather its 256k-vocab embedding and head whole through gloo every step).
TP_PARTS = (
    {"arch": "tinyllama_1_1b", "twin": (2, 1, 2048), "train": (2, 4, 2048, 4, 8),
     "serve": (2, 8, 2048)},
    {"arch": "dbrx_132b", "twin": (1, 1, 2048), "train": (1, 4, 2048, 4, 0),
     "serve": (2, 1, 2048)},
    {"arch": "llama4_scout_17b_a16e", "twin": None, "train": None, "serve": (2, 1, 2048)},
    {"arch": "rwkv6_1_6b", "twin": (4, 2, 2048), "train": (4, 4, 2048, 4, 8),
     "serve": (4, 8, 1024)},
    {"arch": "hymba_1_5b", "twin": (2, 2, 2048), "train": (2, 4, 2048, 4, 8),
     "serve": (4, 8, 2048)},
    {"arch": "seamless_m4t_medium", "twin": (2, 2, 2048), "train": (2, 4, 2048, 4, 0),
     "serve": (4, 8, 2048)},
)


# Phase 20 (d)'s (2, 1) part: DBRX-132B at full width cut to 1 layer on a (2, 1) mesh (dp 2,
# tp 1), each rank its slice of every microbatch and every MoE route over the dp group's whole
# microbatch: one bf16 gradient stage of (batch, seq) at the training factor, a prefill of
# (batch, seq) at the serving factor.
TP_DP = {"arch": "dbrx_132b", "layers": 1, "train": (4, 2048), "serve": (2, 2048)}
TP_DP_TIE = 1e-5                   # two router probabilities this close may order either way
TP_DP_CALLS = ("stage forward", "stage remat recompute", "prefill")


def tp_cfg(part, layers: int, **kw):
    """The part's config cut to ``layers`` (an encoder-decoder's encoder
    too), its width kept."""
    from repro_torch import configs

    cfg = configs.get(part["arch"])
    return cfg.replace(n_layers=layers, **({"enc_layers": layers} if cfg.kind == "encdec"
                                           else {}), **kw)


def tp_batch(cfg, B: int, seq: int, seed: int, dev) -> dict:
    """A part's batch of B rows of ``seq`` positions from ``seed``: token
    ids, or for an encoder-decoder seq/2 frames (float32, scaled as the
    trainer's stub) beside seq/2 tokens."""
    rng = np.random.default_rng(seed)
    encdec = cfg.kind == "encdec"
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, seq // 2 if encdec
                                                                    else seq))).to(dev)}
    if encdec:
        out["src_frames"] = torch.from_numpy((rng.standard_normal(
            (B, seq // 2, cfg.d_model)) * 0.02).astype(np.float32)).to(dev)
    return out


def tp_train_argv(part, dev):
    layers, batch, seq, n_micro, compress = part["train"]
    return (("--arch", part["arch"], "--full", "--layers", str(layers), "--steps",
             str(TP_STEPS), "--batch", str(batch), "--seq", str(seq), "--n-micro",
             str(n_micro), "--ckpt-every", "0", "--device", dev)
            + (("--compress-grads", str(compress)) if compress else ()))


def tp_weights(cfg, dev):
    """A part's weights: the config's init from seed 0, stacked (the
    trainer's ``build``)."""
    from repro_torch.models import Model, stack_layers

    return stack_layers(Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0)))


def tp_serve_cfg(part):
    return tp_cfg(part, part["serve"][0])


def tp_references(dev="cuda") -> dict:
    """Phase 20 (d)'s one-process references, made before the ranks start
    and freed after, by part: the plain trainer's bf16 steps on the run's
    seed and batches, and the plain-served bf16 model's prefill and 16
    greedy decode steps beside its float32 twin's (the same weights in
    float32, the same tokens fed)."""
    from repro_torch import configs
    from repro_torch.launch import train as T
    from repro_torch.models import Model, layer_views

    out = {}
    for part in TP_PARTS:
        ref = out[part["arch"]] = {}
        full = configs.get(part["arch"])
        if part["twin"] and dev == "cuda":      # its weights; the plain stage adds as much again
            reckon("phase 20 (d)'s float32 twin", tp_cfg(part, part["twin"][0], dtype="float32"),
                   full.n_layers, train=False)
        if part["train"]:
            if dev == "cuda":
                reckon("phase 20 (d)'s plain trainer", tp_cfg(part, part["train"][0]),
                       full.n_layers, train=True, compress=bool(part["train"][4]))
            plain, losses, step_s = T.build(T.parser().parse_args(tp_train_argv(part, dev))), [], []
            try:
                for _ in range(TP_STEPS):
                    b = plain.next_batch()
                    sync(dev)
                    t0 = time.perf_counter()
                    losses.append(float(plain.step(b)["loss"]))
                    step_s.append(time.perf_counter() - t0)
            finally:
                plain.pipe.stop()
            ref.update(plain_loss=losses[0], plain_losses=losses, plain_step_s=step_s)
            del plain, b
            empty(dev)
        cfg = tp_serve_cfg(part)
        _, B, S = part["serve"]
        prompt = tp_batch(cfg, B, S, 11, "cpu")
        on_dev = {k: v.to(dev) for k, v in prompt.items()}
        room = prompt["tokens"].shape[1] + TP_DECODE
        params = tp_weights(cfg, dev)
        with torch.no_grad():
            model = Model(cfg, device=dev)
            logits, cache = model.prefill(layer_views(params), on_dev, max_len=room)
            plain, fed = [logits.cpu()], []
            for _ in range(TP_DECODE):
                fed.append(logits.argmax(-1).int())
                logits, cache = model.decode_step(layer_views(params), cache, fed[-1])
                plain.append(logits.cpu())
            del cache
            m32 = Model(cfg.replace(dtype="float32"), device=dev)
            p32 = layer_views(upcast(params))
            del params
            logits, cache = m32.prefill(p32, on_dev, max_len=room)
            f32 = [logits.cpu()]
            for t in fed:
                logits, cache = m32.decode_step(p32, cache, t)
                f32.append(logits.cpu())
            del cache, p32, logits, on_dev
        empty(dev)
        valid = slice(0, cfg.vocab)
        ref.update(prompt=prompt, fed=[t.cpu() for t in fed], f32=f32,
                   plain_dist=[float((a[:, valid] - b[:, valid]).abs().max())
                               for a, b in zip(plain, f32)])
    return out


class RouteReplay:
    """A stand-in for ``models/moe.route`` that takes, call by call, the
    choices another run recorded (``RouteLog.calls``), and counts the
    choices its own top-k would have made otherwise."""

    def __init__(self, calls):
        from repro_torch.models import moe

        self.calls, self._route, self.untied, self.choices = iter(calls), moe.route, 0, 0

    def __call__(self, p, cfg, xt, capacity_factor=None, expert=None, aux_rows=None, dp=None):
        expert = next(self.calls)[0]
        with torch.no_grad():
            self.untied += int((self._route(p, cfg, xt, capacity_factor, dp=dp).expert
                                != expert).sum())
        self.choices += expert.numel()
        return self._route(p, cfg, xt, capacity_factor, expert=expert, aux_rows=aux_rows, dp=dp)


class DpRouteLog:
    """A recording stand-in for ``models/moe.route`` on a dp rank: each
    call's router input (on the host), factor, dp group and its C,
    choices, ranks and keep mask; the router's weights once (layer 0's:
    the only layer of ``TP_DP``)."""

    def __init__(self):
        from repro_torch.models import moe

        self.calls, self.router, self._route = [], None, moe.route

    def __call__(self, p, cfg, xt, capacity_factor=None, expert=None, aux_rows=None, dp=None):
        r = self._route(p, cfg, xt, capacity_factor, expert=expert, aux_rows=aux_rows, dp=dp)
        if self.router is None:
            self.router = p["router"].detach().cpu()
        self.calls.append({"xt": xt.detach().cpu(), "factor": capacity_factor,
                           "dp": None if dp is None else [dp.rank, dp.size],
                           "expert": r.expert.cpu(), "rank": r.rank.cpu(), "keep": r.keep.cpu(),
                           "capacity": r.capacity})
        return r


def tp_twin(mesh, part, dev):
    """(1): a float32 gradient stage of the part's model cut to the twin's
    depth on the mesh against the plain one-process stage on the same
    seed and batch (one microbatch, an MoE's routing replayed from the
    plain run): the loss within 1e-5 relative, every gradient leaf within
    1e-4·max|g|.  The ranks run the plain stage in turns, each keeping its
    shard's slice of the plain gradient on the host, so the card never
    holds two plain states (DBRX's float32 layer is 18 GB of weights)."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding as S
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model, moe
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves, paths

    layers, B, seq = part["twin"]
    cfg = tp_cfg(part, layers, dtype="float32")
    model, ocfg = Model(cfg, device=dev), adamw.AdamWConfig()
    batch = tp_batch(cfg, B, seq, 7, dev)
    rank, routes, want = dist.get_rank(), RouteLog(), {}
    for turn in range(dist.get_world_size()):
        if turn == rank:
            base = tp_weights(cfg, dev)
            with swapped(moe, "route", routes):
                g, loss = make_train_step(model, ocfg, 1).grads(base, batch)
            shard = S.param_shardings(mesh, base)
            for name, t, sh in zip(paths(base), leaves(g), leaves(shard)):
                want[name] = (t[S.shard_slices(t.shape, mesh, sh.placements)].cpu(),
                              float(t.abs().max()))
            want_loss = float(loss)
            del base, g
            empty(dev)
        dist.barrier()
    base = tp_weights(cfg, dev)
    placed = S.place(base, S.param_shardings(mesh, base))
    del base
    replay = RouteReplay(routes.calls)
    with swapped(moe, "route", replay):
        g, loss = make_train_step(model, ocfg, 1).grads(placed, S.place(batch, S.batch_shardings(
            mesh, batch)))
    rel = {n: float((t.to_local() - want[n][0].to(dev)).abs().max()) / want[n][1]
           for n, t in zip(paths(placed), leaves(g))}
    rec = {"layers": layers, "batch": B, "seq": seq, "loss": float(loss), "plain_loss": want_loss,
           "loss_rel": abs(float(loss) - want_loss) / abs(want_loss), "grad_rel": rel,
           "choices_differing_untied": replay.untied, "choices": replay.choices}
    del placed, g, want
    empty(dev)
    if rec["loss_rel"] > TRAIN_LOSS_RTOL or max(rel.values()) > TRAIN_GRAD_RTOL:
        raise AssertionError(f"tp twin ({cfg.name}): the tp step and the plain step "
                             f"disagree: {rec}")
    return rec


class Seen:
    """Records the heads of each call of a kernel wrapper, as it stands in
    for it in ``modules`` (flash_attention's in its ops module and in
    ``models/layers``, the WKV's in ``models/rwkv6``: each takes (B, S,
    heads, d) first)."""

    def __init__(self, modules, name):
        self.modules, self.name, self.heads = modules, name, []
        self.real = getattr(modules[0], name)
        for m in modules:
            setattr(m, name, self)

    def __call__(self, x, *a, **k):
        self.heads.append(x.shape[2])
        return self.real(x, *a, **k)

    def take(self):
        out, self.heads = sorted(set(self.heads)), []
        return out

    def restore(self):
        for m in self.modules:
            setattr(m, self.name, self.real)


def tp_counts(fops, wops, cops) -> dict:
    return {"flash_attention": fops.launches,
            "flash_attention_noncausal": fops.noncausal_launches,
            "flash_attention_windowed": fops.windowed_launches, "rwkv6_chunk": wops.launches,
            "rwkv6_chunk_bwd": wops.bwd_launches, "count_sketch": cops.launches,
            "count_sketch_unsketch": cops.unsketch_launches}


def tp_reset(dev, *ops) -> None:
    """Every count at 0, the peak memory's too: a path starts here."""
    from repro_torch.distributed import tp as TPM

    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    TPM.reset_counters()
    for o in ops:
        o.reset_launches()


def tp_train(mesh, part, ops, seen, dev):
    """(2): the part's bf16 steps through ``launch/train.py``'s ``build``
    on the mesh, the counts at 0 just before the steps and read just
    after; an MoE's routings recorded (remat mismatches, drops, loads)."""
    from repro_torch.distributed import tp as TPM
    from repro_torch.launch import train as T
    from repro_torch.models import moe
    from repro_torch.tree import leaves, paths

    tr = T.build(T.parser().parse_args(tp_train_argv(part, dev)), mesh)
    cfg, routes = tr.model.cfg, RouteLog()
    step_s, losses, norms = [], [], []
    for s in seen:
        s.take()
    tp_reset(dev, *ops)                                                 # the path starts here
    try:
        with swapped(moe, "route", routes):
            for _ in range(TP_STEPS):
                b = tr.next_batch()
                sync(dev)
                t0 = time.perf_counter()
                m = tr.step(b)
                step_s.append(time.perf_counter() - t0)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
    finally:
        tr.pipe.stop()
    rec = {"step_s": step_s, "losses": losses, "grad_norms": norms,
           "train_launches": tp_counts(*ops),                           # ... and ends here
           "train_heads": {s.name: s.take() for s in seen}, "train_staged_bytes": TPM.staged_bytes,
           "train_host_s": dict(TPM.host_seconds),
           "train_peak_bytes": torch.cuda.max_memory_allocated() if dev == "cuda" else 0,
           "sketched_leaves": (sum(p.numel() >= 4 * tr.compressor.ratio for p in leaves(tr.params))
                               if tr.compressor is not None else 0),
           "shards": {n: tuple(t.to_local().shape) for n, t in zip(paths(tr.params),
                                                                   leaves(tr.params))
                      if t.to_local().shape != t.shape}}
    if cfg.kind == "moe":
        rec["remat_routing_mismatches"], rec["remat_routing_pairs"] = routes.remat_mismatches(
            cfg.n_layers)
        rec["routing_by_layer"] = routes.stats(cfg.n_layers, cfg.n_experts)
        rec["experts_held"] = tr.params["layers"]["moe"]["w_gate"].to_local().shape[1]
    del tr, b, m, routes
    return rec


def tp_serve(mesh, part, inp, ops, seen, dev):
    """(3): ``steps.placed_prefill`` of the part's prompt with room for 16
    tokens, then 16 ``placed_decode`` steps of the fed tokens, the counts at
    0 before each and read after; an MoE prefill's drops and loads.
    Returns (the record, the logits gathered)."""
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed import tp as TPM
    from repro_torch.launch import steps as ST
    from repro_torch.models import Model, moe
    from repro_torch.tree import leaves, paths

    cfg = tp_serve_cfg(part)
    model = Model(cfg, device=dev)
    params = tp_weights(cfg, dev)
    placed = S.place(params, S.param_shardings(mesh, params))
    del params
    batch = {k: v.to(dev) for k, v in inp["prompt"].items()}
    room = batch["tokens"].shape[1] + TP_DECODE
    batch = S.place(batch, S.batch_shardings(mesh, batch))
    routes = RouteLog()
    for s in seen:
        s.take()
    tp_reset(dev, *ops)                                                 # the prefill starts here
    sync(dev)
    t0 = time.perf_counter()
    with swapped(moe, "route", routes):
        logits, cache = ST.placed_prefill(model, placed, batch, max_len=room)
    sync(dev)
    rec = {"prefill_s": time.perf_counter() - t0, "prefill_launches": tp_counts(*ops),
           "prefill_heads": {s.name: s.take() for s in seen},
           "cache_local_shapes": {n: tuple(t.to_local().shape) for n, t in zip(
               paths(cache["layers"][0]), leaves(cache["layers"][0]))}}
    if "enc_out" in cache:
        rec["cache_local_shapes"]["enc_out"] = tuple(cache["enc_out"].to_local().shape)
    if cfg.kind == "moe":
        rec["routing"] = {"capacity": [c for _, _, c in routes.calls],
                          "dropped_pairs": [int((~k).sum()) for _, k, _ in routes.calls],
                          "load": [torch.bincount(e.reshape(-1), minlength=cfg.n_experts).tolist()
                                   for e, _, _ in routes.calls]}
    served = [S.gathered(logits).cpu()]
    tp_reset(dev, *ops)                                                 # decode starts here
    decode_s = []
    for t in inp["fed"]:
        tok = {"t": t.to(dev)}
        tok = S.place(tok, S.batch_shardings(mesh, tok))["t"]
        sync(dev)
        t0 = time.perf_counter()
        logits, cache = ST.placed_decode(model, placed, cache, tok)
        sync(dev)
        decode_s.append(time.perf_counter() - t0)
        served.append(S.gathered(logits).cpu())
    rec.update(decode_s=decode_s, decode_launches=tp_counts(*ops),      # ... and ends here
               serve_staged_bytes=TPM.staged_bytes, serve_host_s=dict(TPM.host_seconds),
               serve_host_collectives=TPM.host_collectives,
               serve_peak_bytes=torch.cuda.max_memory_allocated() if dev == "cuda" else 0)
    del placed, cache, logits
    return rec, served


def tp_dp_part(ops, seen, dev):
    """The (2, 1) part on one rank (module docstring): ``TP_DP``'s gradient
    stage and prefill on a (2, 1) mesh, the counts at 0 before each and
    read after, every route recorded.  Returns (the record, the routes)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import sharding as S
    from repro_torch.distributed import tp as TPM
    from repro_torch.launch import steps as ST
    from repro_torch.models import Model, moe
    from repro_torch.optim import adamw

    mesh = init_device_mesh(dev, (TP_WORLD, 1), mesh_dim_names=("data", "model"))
    cfg = tp_cfg(TP_DP, TP_DP["layers"])
    model = Model(cfg, device=dev)
    params = tp_weights(cfg, dev)
    placed = S.place(params, S.param_shardings(mesh, params))
    del params
    empty(dev)
    B, seq = TP_DP["train"]
    batch = S.place_batch(mesh, tp_batch(cfg, B, seq, 13, dev), 1)
    routes = DpRouteLog()
    for s in seen:
        s.take()
    tp_reset(dev, *ops)                                                 # the stage starts here
    sync(dev)
    t0 = time.perf_counter()
    with swapped(moe, "route", routes):
        g, loss = ST.make_train_step(model, adamw.AdamWConfig(), 1).grads(placed, batch)
    sync(dev)
    rec = {"stage_s": time.perf_counter() - t0, "loss": float(loss),
           "stage_launches": tp_counts(*ops), "stage_heads": {s.name: s.take() for s in seen},
           "stage_staged_bytes": TPM.staged_bytes, "stage_host_s": dict(TPM.host_seconds),
           "stage_peak_bytes": torch.cuda.max_memory_allocated() if dev == "cuda" else 0,
           "local_rows": batch["tokens"].to_local().shape[0]}
    del g, batch
    empty(dev)
    B, seq = TP_DP["serve"]
    batch = S.place_batch(mesh, tp_batch(cfg, B, seq, 11, dev))
    tp_reset(dev, *ops)                                                 # the prefill starts here
    sync(dev)
    t0 = time.perf_counter()
    with swapped(moe, "route", routes):
        logits, cache = ST.placed_prefill(model, placed, batch)
    sync(dev)
    rec.update(prefill_s=time.perf_counter() - t0, prefill_launches=tp_counts(*ops),
               prefill_heads={s.name: s.take() for s in seen},
               prefill_staged_bytes=TPM.staged_bytes,
               prefill_finite=bool(torch.isfinite(logits.to_local()[:, :cfg.vocab]).all()))
    del placed, batch, logits, cache
    empty(dev)
    return rec, {"calls": routes.calls, "router": routes.router}


def tp_dp_check(ranks, routes, dev) -> tuple:
    """The (2, 1) part's gates on the ranks' records: every route call's
    C, ranks and keep mask those of the one-process route of the same
    microbatch's router inputs (the ranks' rows in dp order) with the
    ranks' choices, and those choices its own top-k's but where two
    probabilities tie within ``TP_DP_TIE``; the forward and its remat
    recompute routed alike; the stage's loss finite and within
    ``TP_LOSS_RTOL`` of the one-process stage's; flash_attention twice in
    the stage and once in the prefill, on all 48 heads.  Returns (what it
    printed as a dict, the failures)."""
    from repro_torch.models import moe

    cfg = tp_cfg(TP_DP, TP_DP["layers"])
    bad, calls = [], []
    for i, parts in enumerate(zip(*(r["calls"] for r in routes))):
        xt = torch.cat([c["xt"] for c in parts]).to(dev)
        mine = {k: torch.cat([c[k] for c in parts]) for k in ("expert", "rank", "keep")}
        p = {"router": routes[0]["router"].to(dev)}
        with torch.no_grad():
            own = moe.route(p, cfg, xt, parts[0]["factor"])
            replay = moe.route(p, cfg, xt, parts[0]["factor"], expert=mine["expert"].to(dev))
            probs = torch.softmax(xt.float() @ p["router"], -1)
        differ = (own.expert.cpu() != mine["expert"]).any(1)
        top = torch.sort(probs[differ.to(dev)], -1, descending=True).values
        gaps = (top[:, cfg.top_k - 1] - top[:, cfg.top_k]).cpu() if len(top) else torch.zeros(0)
        rec = {"call": i, "what": TP_DP_CALLS[i] if i < len(TP_DP_CALLS) else f"call {i}",
               "factor": parts[0]["factor"] or cfg.capacity_factor,
               "tokens": xt.shape[0], "capacity": [c["capacity"] for c in parts],
               "one_process_capacity": replay.capacity, "dp": [c["dp"] for c in parts],
               "dropped_pairs": int((~replay.keep).sum()),
               "dropped_by_rank": [int((~c["keep"]).sum()) for c in parts],
               "choices_differing": int(differ.sum())}
        calls.append(rec)
        if any(c["capacity"] != replay.capacity for c in parts):
            bad.append(f"dp route {i}: capacities {rec['capacity']}, one process "
                       f"{replay.capacity}")
        if not (torch.equal(replay.rank.cpu(), mine["rank"])
                and torch.equal(replay.keep.cpu(), mine["keep"])):
            bad.append(f"dp route {i}: ranks or keep mask differ from the one-process route's")
        if len(gaps) and float(gaps.max()) > TP_DP_TIE:
            bad.append(f"dp route {i}: {rec['choices_differing']} choices differ, gap "
                       f"{float(gaps.max())}")
    for r, rt in zip(ranks, routes):
        d, tag = r["dp"], f"tp (2, 1) rank {r['rank']}"
        fwd, again = rt["calls"][0], rt["calls"][1]
        if not (torch.equal(fwd["expert"], again["expert"])
                and torch.equal(fwd["keep"], again["keep"])):
            bad.append(f"{tag}: the remat recompute routed otherwise than its forward")
        if len(rt["calls"]) != len(TP_DP_CALLS):
            bad.append(f"{tag}: {len(rt['calls'])} route calls, expected 3")
        want_stage, want_prefill = {"flash_attention": 2}, {"flash_attention": 1}
        got_stage = {k: v for k, v in d["stage_launches"].items() if v}
        got_prefill = {k: v for k, v in d["prefill_launches"].items() if v}
        if (got_stage != want_stage or got_prefill != want_prefill
                or d["stage_heads"]["flash_attention_gqa"] != [cfg.n_heads]):
            bad.append(f"{tag}: launches {got_stage} / {got_prefill} on heads "
                       f"{d['stage_heads']}")
        if not math.isfinite(d["loss"]) or abs(d["loss"] - d["plain_loss"]) > (
                TP_LOSS_RTOL * abs(d["plain_loss"])):
            bad.append(f"{tag}: loss {d['loss']} against the one-process stage's "
                       f"{d['plain_loss']}")
        if not d["prefill_finite"]:
            bad.append(f"{tag}: the prefill's logits are not finite")
    return calls, bad


def tp_dp_reference(dev) -> dict:
    """The (2, 1) part's one-process gradient stage on the same weights and
    microbatch (its loss), in this process before the ranks start."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import adamw

    cfg = tp_cfg(TP_DP, TP_DP["layers"])
    B, seq = TP_DP["train"]
    model, base = Model(cfg, device=dev), tp_weights(cfg, dev)
    sync(dev)
    t0 = time.perf_counter()
    g, loss = make_train_step(model, adamw.AdamWConfig(), 1).grads(
        base, tp_batch(cfg, B, seq, 13, dev))
    sync(dev)
    out = {"loss": float(loss), "stage_s": time.perf_counter() - t0,
           "peak_bytes": torch.cuda.max_memory_allocated() if dev == "cuda" else 0}
    del g, base
    empty(dev)
    return out


def tp_rank(rank: int, world: int, tmp: str, dev: str) -> None:
    """One rank of phase 20 (d): joins the gloo group, runs its work and
    writes its record (and rank 0 its served logits)."""
    import datetime
    import pickle

    import torch.distributed as dist

    if dev == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(max(1, 8 // world))
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    try:
        with open(f"{tmp}/inputs.pkl", "rb") as fh:
            inp = pickle.load(fh)
        out, logits, routes = tp_work(rank, world, inp, dev)
        if rank == 0:
            torch.save(logits, f"{tmp}/logits.pt")
        torch.save(routes, f"{tmp}/dp_routes{rank}.pt")
        with open(f"{tmp}/rank{rank}.json", "w") as fh:
            json.dump(out, fh)
    finally:
        dist.destroy_process_group()


def tp_work(rank: int, world: int, inp: dict, dev: str):
    """Phase 20 (d) on one rank (module docstring), part by part: the
    float32 twin, then the main path, each of its runs with every count at
    0 before it: the bf16 train steps, a prefill and 16 decode steps."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels.count_sketch import ops as cops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rwkv6_chunk import ops as wops
    from repro_torch.models import layers as LY
    from repro_torch.models import rwkv6

    if dev == "cpu":                     # a CPU rehearsal counts the plain versions' calls
        counting_cpu_kernels(fops, cops, wops)
    mesh = init_device_mesh(dev, (1, world), mesh_dim_names=("data", "model"))
    ops = (fops, wops, cops)
    seen = (Seen((fops, LY), "flash_attention_gqa"), Seen((rwkv6,), "rwkv6_chunk"))
    out, served = {"rank": rank, "mesh": [1, world], "transport": "gloo through the host",
                   "parts": {}}, {}
    try:
        for part in TP_PARTS:
            rec = out["parts"][part["arch"]] = {}
            t0 = time.perf_counter()
            if part["twin"]:
                rec["twin_f32"] = tp_twin(mesh, part, dev)
            t1 = time.perf_counter()
            if part["train"]:
                rec.update(tp_train(mesh, part, ops, seen, dev))
                empty(dev)
            t2 = time.perf_counter()
            srec, served[part["arch"]] = tp_serve(mesh, part, inp[part["arch"]], ops, seen, dev)
            rec.update(srec, seconds={"twin": t1 - t0, "train": t2 - t1,
                                      "serve": time.perf_counter() - t2})
            empty(dev)
            log(f"  rank {rank}: {part['arch']} done, seconds {rec['seconds']}")
        t0 = time.perf_counter()
        out["dp"], routes = tp_dp_part(ops, seen, dev)
        out["dp"]["seconds"] = time.perf_counter() - t0
        log(f"  rank {rank}: the (2, 1) part done, seconds {out['dp']['seconds']:.1f}")
    finally:
        for s in seen:
            s.restore()
    return out, served, routes


def empty(dev) -> None:
    """Free what the collector can and, on the card, the cache's blocks."""
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()


def counting_cpu_kernels(fops, cops, wops=None):
    """A CPU rehearsal's stand-ins: the plain flash_attention, WKV (forward
    and backward) and sketches, each call counted as a launch."""
    from repro_torch.optim import grad_compress

    real_attn, real_sk, real_un = (fops.flash_attention_gqa, grad_compress.count_sketch_hashed,
                                   grad_compress.unsketch)

    def attn(q, k, v, causal=True, return_lse=False, window=None):
        fops.launches += 1
        fops.windowed_launches += window is not None
        fops.noncausal_launches += not causal
        return real_attn(q, k, v, causal, return_lse, window)

    def sk(*a, **k):
        cops.launches += 1
        return real_sk(*a, **k)

    def un(*a, **k):
        cops.unsketch_launches += 1
        return real_un(*a, **k)
    fops.flash_attention_gqa, grad_compress.count_sketch_hashed, grad_compress.unsketch = (
        attn, sk, un)
    if wops is not None:
        real_fwd, real_bwd = wops._forward, wops.rwkv6_chunk_bwd

        def fwd(*a, **k):
            wops.launches += 1
            return real_fwd(*a, **k)

        def bwd(*a, **k):
            wops.bwd_launches += 1
            return real_bwd(*a, **k)
        wops._forward, wops.rwkv6_chunk_bwd = fwd, bwd


def tp_attention_launches(cfg, passes: int) -> dict:
    """flash_attention's launches in ``passes`` forward passes of ``cfg``:
    one an attention (an encoder-decoder's encoder, self- and
    cross-attention), the non-causal ones (encoder, cross) and the windowed
    ones apart."""
    windowed = sum(w is not None for w in
                   (None if not cfg.window or i in cfg.global_layers else cfg.window
                    for i in range(cfg.n_layers)))
    encdec = cfg.kind == "encdec"
    return {"flash_attention": passes * (cfg.n_layers + (cfg.enc_layers + cfg.n_layers
                                                         if encdec else 0)),
            "flash_attention_noncausal": passes * (cfg.enc_layers + cfg.n_layers if encdec
                                                   else 0),
            "flash_attention_windowed": passes * windowed}


def tp_want(part, cfg) -> dict:
    """A part's launch counts: (its train steps', a prefill's, a decode
    step's) and the heads each kernel sees on a tp rank (all of them where
    tp does not divide them: Hymba's 25)."""
    z = dict.fromkeys(("flash_attention", "flash_attention_noncausal",
                       "flash_attention_windowed", "rwkv6_chunk", "rwkv6_chunk_bwd",
                       "count_sketch", "count_sketch_unsketch"), 0)
    rwkv, train = cfg.kind == "rwkv", None
    if part["train"]:
        layers, _, _, n_micro, compress = part["train"]
        fwd = 2 * layers * n_micro * TP_STEPS                 # forward and remat recompute
        train = {**z, **({"rwkv6_chunk": fwd, "rwkv6_chunk_bwd": fwd // 2} if rwkv
                         else tp_attention_launches(tp_cfg(part, layers),
                                                    2 * n_micro * TP_STEPS))}
    prefill = {**z, **({"rwkv6_chunk": part["serve"][0]} if rwkv
                       else tp_attention_launches(cfg, 1))}
    heads = (cfg.d_model // cfg.rwkv_head_size) if rwkv else cfg.n_heads
    return {"train": train, "prefill": prefill, "decode": z,
            "heads": heads // TP_WORLD if heads % TP_WORLD == 0 else heads,
            "kernel": "rwkv6_chunk" if rwkv else "flash_attention_gqa"}


def phase_tp(dev="cuda") -> dict:
    """Phase 20 (d) (module docstring): the references in this process,
    then two ranks sharing the card over gloo, spawned, joined within
    ``TP_TIMEOUT_S``; the gates; returns the ranks' records."""
    import multiprocessing
    import pickle
    import tempfile

    t0 = time.perf_counter()
    ref = tp_references(dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    dp_ref = tp_dp_reference(dev)
    ref_s = time.perf_counter() - t0
    log(f"  phase 20 (d)'s references took {ref_s:.1f}s")
    with tempfile.TemporaryDirectory() as tmp:
        with open(f"{tmp}/inputs.pkl", "wb") as fh:
            pickle.dump({a: {"prompt": r["prompt"], "fed": r["fed"]} for a, r in ref.items()}, fh)
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=tp_rank, args=(r, TP_WORLD, tmp, dev))
                 for r in range(TP_WORLD)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + TP_TIMEOUT_S
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                break                                 # one rank failed: stop the others
            time.sleep(0.5)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
        codes = [p.exitcode for p in procs]
        if codes != [0] * TP_WORLD:
            raise AssertionError(f"tp: ranks exited with {codes} (a kill: one failed, or "
                                 f"{TP_TIMEOUT_S:.0f} s passed)")
        ranks = [json.loads(Path(f"{tmp}/rank{r}.json").read_text()) for r in range(TP_WORLD)]
        served = torch.load(f"{tmp}/logits.pt")
        dp_routes = [torch.load(f"{tmp}/dp_routes{r}.pt") for r in range(TP_WORLD)]
    out = {"mesh": [1, TP_WORLD], "transport": "gloo through the host", "references_s": ref_s,
           "steps": TP_STEPS, "decode": TP_DECODE, "parts": {}, "ranks": ranks}
    bad = []
    for part in TP_PARTS:
        arch, r0 = part["arch"], ref[part["arch"]]
        cfg = tp_serve_cfg(part)
        want, valid = tp_want(part, cfg), slice(0, cfg.vocab)
        noise = max(r0["plain_dist"])
        dist_tp = [float((a[:, valid] - b[:, valid]).abs().max())
                   for a, b in zip(served[arch], r0["f32"])]
        out["parts"][arch] = {**{k: part[k] for k in ("twin", "train", "serve")},
                              "plain_dist": r0["plain_dist"], "tp_dist": dist_tp,
                              "noise_limit": TP_NOISE * noise,
                              **({"plain_losses": r0["plain_losses"],
                                  "plain_step_ms": [x * 1e3 for x in r0["plain_step_s"]]}
                                 if part["train"] else {})}
        for r in ranks:
            rec, tag = r["parts"][arch], f"tp {arch} rank {r['rank']}"
            if "twin_f32" in rec:
                tw = rec["twin_f32"]
                log(f"  {tag} of (1, {TP_WORLD}) over gloo through the host (not NVLink): float32 "
                    f"twin ({tw['layers']} layers, {tw['batch']} x {tw['seq']}) loss rel "
                    f"{tw['loss_rel']:.2e}, grads max rel {max(tw['grad_rel'].values()):.2e}"
                    + (f"; routing replayed: {tw['choices_differing_untied']} of "
                       f"{tw['choices']} choices would have differed untied"
                       if tw["choices"] else ""))
            if part["train"]:
                log(f"    bf16 steps {', '.join(f'{x * 1e3:.1f}' for x in rec['step_s'])} ms (the "
                    f"plain trainer's {', '.join(f'{x * 1e3:.1f}' for x in r0['plain_step_s'])} "
                    f"ms), losses {rec['losses']} (plain {r0['plain_losses']}), launches "
                    f"{ {k: v for k, v in rec['train_launches'].items() if v} } on heads "
                    f"{rec['train_heads']}, staged {rec['train_staged_bytes'] / 1e9:.2f} GB "
                    f"(host s { {k: round(v, 2) for k, v in rec['train_host_s'].items()} }), peak "
                    f"{rec['train_peak_bytes'] / 2 ** 30:.2f} GiB; shards {rec['shards']}")
                if cfg.kind == "moe":
                    log(f"    experts held {rec['experts_held']} of {cfg.n_experts}; remat "
                        f"routing mismatches {rec['remat_routing_mismatches']} of "
                        f"{rec['remat_routing_pairs']} pairs; routing by layer (drops, loads) "
                        f"{rec['routing_by_layer']}")
            launched = {k: v for k, v in rec["prefill_launches"].items() if v}
            host_s = {k: round(v, 2) for k, v in rec["serve_host_s"].items()}
            log(f"    prefill {part['serve'][1]} x {part['serve'][2]} ({part['serve'][0]} layers) "
                f"{rec['prefill_s'] * 1e3:.1f} ms ({launched} on heads {rec['prefill_heads']}, "
                f"cache layer {rec['cache_local_shapes']} a rank), decode "
                f"{1e3 * sum(rec['decode_s']) / max(1, len(rec['decode_s'])):.2f} ms a token "
                f"({sum(rec['decode_launches'].values())} launches), staged "
                f"{rec['serve_staged_bytes'] / 1e9:.3f} GB in {rec['serve_host_collectives']} host "
                f"collectives (host s {host_s}), peak {rec['serve_peak_bytes'] / 2 ** 30:.2f} GiB"
                + (f"; prefill routing at factor 4.0: drops {rec['routing']['dropped_pairs']}, "
                   f"loads {rec['routing']['load']}" if cfg.kind == "moe" else ""))
            if part["train"]:
                if not all(math.isfinite(x) for x in rec["losses"]):
                    bad.append(f"{tag}: losses {rec['losses']}")
                if abs(rec["losses"][0] - r0["plain_loss"]) > TP_LOSS_RTOL * abs(r0["plain_loss"]):
                    bad.append(f"{tag}: step 1's loss {rec['losses'][0]} against the plain "
                               f"{r0['plain_loss']}")
                sk = rec["sketched_leaves"] * TP_STEPS
                train_want = {**want["train"], "count_sketch": sk, "count_sketch_unsketch": sk}
                if (rec["train_launches"] != train_want
                        or rec["train_heads"][want["kernel"]] != [want["heads"]]):
                    bad.append(f"{tag}: train launches {rec['train_launches']} on "
                               f"{rec['train_heads']}, expected {train_want} on {want['heads']}")
                if cfg.kind == "moe" and rec["remat_routing_mismatches"]:
                    bad.append(f"{tag}: {rec['remat_routing_mismatches']} remat routing "
                               f"mismatches")
            if (rec["prefill_launches"] != want["prefill"]
                    or rec["prefill_heads"][want["kernel"]] != [want["heads"]]):
                bad.append(f"{tag}: prefill launches {rec['prefill_launches']} on "
                           f"{rec['prefill_heads']}, expected {want['prefill']}")
            if rec["decode_launches"] != want["decode"]:
                bad.append(f"{tag}: decode launched {rec['decode_launches']}")
            if cfg.kind == "moe" and any(rec["routing"]["dropped_pairs"]):
                bad.append(f"{tag}: the prefill dropped pairs {rec['routing']['dropped_pairs']}")
        log(f"  {arch}: logits' distance to the float32 twin: tp {max(dist_tp):.4f} (prefill "
            f"{dist_tp[0]:.4f}), the plain-served bf16 model's {noise:.4f} (limit "
            f"{TP_NOISE * noise:.4f})")
        if max(dist_tp) > TP_NOISE * noise or not all(math.isfinite(x) for x in dist_tp):
            bad.append(f"tp {arch}: served logits {dist_tp} from the float32 twin, past "
                       f"{TP_NOISE} x the plain model's {noise}")
    for r in ranks:
        r["dp"]["plain_loss"] = dp_ref["loss"]
    dp_calls, dp_bad = tp_dp_check(ranks, dp_routes, dev)
    bad += dp_bad
    del dp_routes
    out["dp"] = {"reference": dp_ref, "routes": dp_calls}
    log(f"  (2, 1) {TP_DP['arch']} at {TP_DP['layers']} layer, full width, dp 2 over gloo "
        f"through the host: the one-process stage's loss {dp_ref['loss']:.6f} "
        f"({dp_ref['stage_s'] * 1e3:.1f} ms, peak {dp_ref['peak_bytes'] / 2 ** 30:.2f} GiB)")
    for r in ranks:
        d = r["dp"]
        log(f"    rank {r['rank']}: {d['local_rows']} of {TP_DP['train'][0]} rows; gradient "
            f"stage {d['stage_s'] * 1e3:.1f} ms, loss {d['loss']:.6f}, staged "
            f"{d['stage_staged_bytes'] / 1e9:.2f} GB (host s "
            f"{ {k: round(v, 2) for k, v in d['stage_host_s'].items()} }), peak "
            f"{d['stage_peak_bytes'] / 2 ** 30:.2f} GiB; prefill {TP_DP['serve'][0]} x "
            f"{TP_DP['serve'][1]} {d['prefill_s'] * 1e3:.1f} ms, staged "
            f"{d['prefill_staged_bytes'] / 1e9:.2f} GB; launches "
            f"{ {k: v for k, v in d['stage_launches'].items() if v} } / "
            f"{ {k: v for k, v in d['prefill_launches'].items() if v} } on heads "
            f"{d['stage_heads']}; {d['seconds']:.1f} s in all")
    for c in dp_calls:
        log(f"    route {c['call']} ({c['what']}) at factor {c['factor']} over {c['tokens']} tokens: C {c['capacity']} a rank, "
            f"one process {c['one_process_capacity']}; pairs dropped {c['dropped_pairs']} "
            f"({c['dropped_by_rank']} by rank), ranks and keep mask equal to the one-process "
            f"route's; {c['choices_differing']} choices differ from its own top-k (ties)")
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 20 (d) took {out['seconds']:.1f}s (references {ref_s:.1f}s)")
    if bad:
        raise AssertionError("tp: " + "; ".join(bad))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-fact", type=int, default=1 << 22, help="serve-phase fact rows")
    ap.add_argument("--paper-n-fact", type=int, default=1 << 18, help="paper-phase fact rows")
    ap.add_argument("--coeff-n-fact", type=int, default=1 << 20,
                    help="phase-4 fact rows (coefficient-domain and histogram fits)")
    ap.add_argument("--profile", action="store_true",
                    help="after phase 2, trace one more training round and one scoring "
                         "pass per table, in phases 5 and 6 16 decode steps, in phase 7 "
                         "one more train step, and in phase 8 one more delta batch's apply "
                         "and refresh and one more refit, with torch.profiler and print the "
                         "device's busy and idle share")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.kernels import (count_sketch, flash_attention, polymul, rwkv6_chunk,
                                     segment_sum)
    from repro_torch.kernels.count_sketch import ops as cops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.polymul import ops as pops
    from repro_torch.kernels.rwkv6_chunk import ops as wops
    from repro_torch.kernels.segment_sum import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log("card (nvidia-smi name, power.limit):")
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, capability "
        f"{torch.cuda.get_device_capability(0)}")

    t0 = time.perf_counter()
    sources = (segment_sum.build, polymul.build, rwkv6_chunk.build, rwkv6_chunk.build_bwd,
               flash_attention.build, count_sketch.build)
    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc per source, started together
        builds = list(pool.map(lambda build: build(verbose=True), sources))
    log(f"build: {', '.join(lib.name for lib, _ in builds)} in "
        f"{time.perf_counter() - t0:.2f}s")
    dry = dryrun_start()                 # phase 20 (c) needs no card: its cells run meanwhile
    for _, build_log in builds:
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")

    log("phase 1: segment_sum, polymul, rwkv6_chunk, its backward, flash_attention and "
        "count_sketch kernels vs plain versions on the card")
    shapes = phase_kernel(ops, ref)
    pshapes = phase_polymul(pops, polymul)
    wshapes = phase_wkv(wops, rwkv6_chunk)
    wstrong = wkv_strong_decay(wops, rwkv6_chunk)
    bshapes = phase_wkv_bwd(wops, rwkv6_chunk)
    fsass = attention_sass(fops, builds[sources.index(flash_attention.build)][0])
    fshapes = phase_attn(fops, flash_attention)
    cshapes = phase_sketch(cops, count_sketch)
    log(f"phase 2: serve path at {args.n_fact} fact rows")
    serve, serve_schema, serve_trees, serve_ens, serve_scores = phase_serve(ops, args.n_fact,
                                                              profile=args.profile)
    log(f"phase 3: paper check at {args.paper_n_fact} fact rows")
    paper = phase_paper(args.paper_n_fact)
    log(f"phase 4: paper's coefficient-domain sketch and histogram splits at "
        f"{args.coeff_n_fact} fact rows")
    coeff, coeff_schema = phase_coeff_hist(pops, ops, args.coeff_n_fact)
    log(f"phase 8: incremental maintenance on phase 2's schema and trees "
        f"({MAINTAIN_BATCHES} delta batches, WAL, checkpoint, recovery), then warm-start "
        f"refits on phase 4's schema")
    t0 = time.perf_counter()
    for o in (pops, wops, fops, cops):
        o.reset_launches()
    maintain = phase_maintain(ops, serve_schema, serve_trees, profile=args.profile)
    retrain = phase_retrain(ops, coeff_schema, profile=args.profile)
    if any(o.launches for o in (pops, wops, fops, cops)):
        raise AssertionError("phase 8 launched a kernel other than segment_sum: "
                             f"{[(o.__name__, o.launches) for o in (pops, wops, fops, cops)]}")
    phase8_s = time.perf_counter() - t0
    log(f"  phase 8 took {phase8_s:.1f}s")
    log("phase 9: the operated service on phase 2's schema and model: telemetry on, four "
        "A/B variants in one stacked pass, a WAL-follower replica of a live writer")
    operate = phase_operate(ops, serve_schema, serve_trees, serve_ens)
    if any(o.launches for o in (pops, wops, fops, cops)):
        raise AssertionError("phase 9 launched a kernel other than segment_sum: "
                             f"{[(o.__name__, o.launches) for o in (pops, wops, fops, cops)]}")
    log(f"phase 10: phase 2's schema and model data-parallel over {DP_WORLD} ranks sharing "
        f"the one card over gloo (correctness and the collectives' host cost, not multi-card "
        f"speed); (b)'s fits on the first {DP_FIT_ROWS} of its {args.n_fact} fact rows (for phase "
        f"20 (d)'s time); (d) a WAL follower on the mesh, {DP_FOLLOW[2] - DP_FOLLOW[1]} records "
        f"live")
    dp = phase_data_parallel(serve_schema, serve_trees, serve_scores, serve["times"])
    del serve_schema, serve_trees, serve_ens, serve_scores     # phases 5-7 run without them
    gc.collect()                          # a scorer and its snapshots hold each other
    torch.cuda.empty_cache()
    host = {"phase 5": host_state("phase 5")}
    lm_cfg = configs.get("rwkv6_1_6b")
    log(f"phase 5: {lm_cfg.name} serving at full width: prefill 8 x 1024, decode 64 tokens")
    from repro_torch.models import layers, rwkv6
    lm = phase_lm(wops, (ops, pops, fops, cops), lm_cfg,
                  (rwkv6, "rwkv6_chunk", rwkv6_chunk.rwkv6_chunk_ref), profile=args.profile)
    torch.cuda.empty_cache()
    dense_cfg = configs.get("tinyllama_1_1b")
    log(f"phase 6: {dense_cfg.name} serving at full width: prefill 8 x 2048 with cache room "
        f"for 64 decode tokens, decode 64 tokens")
    attn_plain = (layers, "flash_attention_gqa", flash_attention.flash_attention_ref)
    dense = phase_lm(fops, (ops, pops, wops, cops), dense_cfg, attn_plain,
                     prompt=2048, max_len=2048 + 64, check_last=True, profile=args.profile,
                     oracle=flash_attention.attention_limit)
    torch.cuda.empty_cache()
    log(f"phase 7: {dense_cfg.name} training at full width: global batch 8 x 2048, n_micro 8, "
        f"count-sketch compression 8, 4 steps after a warm-up step")
    host["phase 7"] = host_state("phase 7")
    train = phase_train(fops, cops, (ops, pops, wops), profile=args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 11 (a): the paper's config fitted on phase 4's star ({args.coeff_n_fact} fact "
        f"rows, one a document), then its sampling weights from one pass")
    for o in (pops, wops, fops, cops):
        o.reset_launches()
    bridge, weights = phase_bridge(ops, coeff_schema)
    if any(o.launches for o in (pops, wops, fops, cops)):
        raise AssertionError("phase 11 (a) launched a kernel other than segment_sum: "
                             f"{[(o.__name__, o.launches) for o in (pops, wops, fops, cops)]}")
    del coeff_schema
    gc.collect()
    torch.cuda.empty_cache()
    host["phase 11 (b)"] = host_state("phase 11 (b)")
    log(f"phase 11 (b): rwkv6-1.6b training at full width on batches drawn by phase 11 (a)'s "
        f"weights: global batch 8 x 2048, n_micro 8, count-sketch compression 8, {RWKV_STEPS} "
        f"steps after a warm-up step (cut from 4 for phase 20 (d)'s time)")
    rwkv_train = phase_rwkv_train(wops, cops, (ops, pops, fops), weights, steps=RWKV_STEPS,
                                  profile=args.profile)
    dense_serve = []
    for arch, batch, depth in DENSE_SERVE:
        gc.collect()
        torch.cuda.empty_cache()                        # the card holds nothing else
        cfg = configs.get(arch)
        cfg = cfg if depth is None else cfg.replace(n_layers=depth)
        log(f"phase 12: {cfg.name} serving at full width, {cfg.n_layers} layers"
            + ("" if depth is None else f" (cut from {configs.get(arch).n_layers})")
            + f": prefill {batch} x 2048 with cache room for 64 decode tokens, decode 64 tokens")
        dense_serve.append(phase_lm(fops, (ops, pops, wops, cops), cfg, attn_plain, batch=batch,
                                    prompt=2048, max_len=2048 + 64, check_last=True,
                                    oracle=flash_attention.attention_limit,
                                    twin_cfg=cfg.replace(dtype="float32", n_layers=2)))
    gc.collect()
    torch.cuda.empty_cache()                            # the card holds nothing else
    hymba_cfg = configs.get("hymba_1_5b")
    log(f"phase 13: {hymba_cfg.name} serving at full width, {hymba_cfg.n_layers} layers (window "
        f"{hymba_cfg.window}, global layers {hymba_cfg.global_layers}, "
        f"{hymba_cfg.meta_tokens} meta tokens): prefill 8 x 2048 with cache room for 64 decode "
        f"tokens, decode 64 tokens")
    hymba = phase_lm(fops, (ops, pops, wops, cops), hymba_cfg, attn_plain, batch=8, prompt=2048,
                     max_len=2048 + 64, check_last=True, profile=args.profile,
                     oracle=flash_attention.attention_limit,
                     twin_cfg=hymba_cfg.replace(dtype="float32", n_layers=2, global_layers=(0,)),
                     annotated=("ssm_branch",))
    gc.collect()
    torch.cuda.empty_cache()                            # the card holds nothing else
    host["phase 14"] = host_state("phase 14")
    log(f"phase 14: {hymba_cfg.name} training at full width and depth: global batch 8 x 2048 "
        f"(+{hymba_cfg.meta_tokens} meta positions a row), n_micro 8, count-sketch compression "
        f"8, {HYMBA_STEPS} step(s) after a warm-up step (cut from 4, then 2, for phase 20 (d)'s "
        f"time)")
    hymba_train = phase_hymba_train(fops, cops, (ops, pops, wops), cshapes, steps=HYMBA_STEPS)
    moe_serve = []
    for arch, depth in MOE_SERVE:
        gc.collect()
        torch.cuda.empty_cache()                        # the card holds nothing else
        cfg = configs.get(arch).replace(n_layers=depth)
        log(f"phase 15: {cfg.name} serving at full width, {depth} layers (cut from "
            f"{configs.get(arch).n_layers}; {cfg.n_experts} experts, top {cfg.top_k}"
            f"{', a shared expert' if cfg.shared_expert else ''}): prefill 1 x 2048 with cache "
            f"room for 64 decode tokens, decode 64 tokens")
        moe_serve.append(phase_lm(fops, (ops, pops, wops, cops), cfg, attn_plain, batch=1,
                                  prompt=2048, max_len=2048 + 64, check_last=True,
                                  oracle=flash_attention.attention_limit,
                                  twin_cfg=cfg.replace(dtype="float32", n_layers=2),
                                  annotated=("moe_experts",), inspect=moe_routing))
    moe_train = []
    for arch in MOE_TRAIN:
        gc.collect()
        torch.cuda.empty_cache()                        # the card holds nothing else
        cfg = configs.get(arch)
        log(f"phase 16: {cfg.name} training at full width, 1 layer (cut from {cfg.n_layers}): "
            f"global batch 8 x 2048, n_micro 8, remat, AdamW, no compression, 4 steps after a "
            f"warm-up step, capacity factor {cfg.capacity_factor}")
        moe_train.append(phase_moe_train(fops, (ops, pops, wops, cops), arch))
    gc.collect()
    torch.cuda.empty_cache()                            # the card holds nothing else
    ecfg = configs.get(ENCDEC)
    log(f"phase 17: {ecfg.name} serving at full width and depth ({ecfg.enc_layers} encoder and "
        f"{ecfg.n_layers} decoder layers): prefill 8 x (1024 frames + 1024 tokens) with cache "
        f"room for 64 decode tokens, decode 64 tokens")
    reckon("phase 17", ecfg, ecfg.n_layers, train=False)
    encdec_serve = phase_lm(
        fops, (ops, pops, wops, cops), ecfg, attn_plain, batch=8, prompt=1024,
        max_len=1024 + 64, check_last=True, profile=args.profile,
        oracle=flash_attention.attention_limit,
        twin_cfg=ecfg.replace(dtype="float32", n_layers=2, enc_layers=2), stub=1024,
        want_launches={"launches": ecfg.enc_layers + 2 * ecfg.n_layers,
                       "noncausal_launches": ecfg.enc_layers + ecfg.n_layers})
    gc.collect()
    torch.cuda.empty_cache()
    host["phase 18"] = host_state("phase 18")
    log(f"phase 18: {ecfg.name} training at full width and depth: global batch 8 x (1024 frames "
        f"+ 1024 tokens), n_micro 8, count-sketch compression 8, 4 steps after a warm-up step")
    encdec_train = phase_encdec_train(fops, cops, (ops, pops, wops))
    gc.collect()
    torch.cuda.empty_cache()                            # the card holds nothing else
    lcfg, lplan = serve_depth("llava_next_34b", 1, 2048)
    log(f"phase 19: {lcfg.name} serving at full width, {lcfg.n_layers} layers: prefill 1 x "
        f"(1024 patch embeddings + 1024 tokens) with cache room for 64 decode tokens, decode 64 "
        f"tokens")
    llava = phase_lm(fops, (ops, pops, wops, cops), lcfg, attn_plain, batch=1, prompt=1024,
                     max_len=1024 + 64, check_last=True, oracle=flash_attention.attention_limit,
                     twin_cfg=lcfg.replace(dtype="float32", n_layers=2), stub=1024)
    llava["reckoning"] = lplan
    gc.collect()
    torch.cuda.empty_cache()                            # the card holds nothing else
    log("phase 20: tinyllama-1.1b trained placed on make_host_mesh() (1 x 1 here) at full width, "
        "4 of its 22 layers (cut for phase 20 (d)'s time), global batch 8 x 2048, n_micro 8, "
        "compression 8, 2 steps beside the plain trainer; its checkpoint restored onto "
        "rebuild_mesh(1); six dry-run cells at full size (two also on the gathered path)")
    placed = phase_placed(fops, cops, (ops, pops, wops))
    placed["dryrun"] = dryrun_cells(dry)
    gc.collect()
    torch.cuda.empty_cache()                            # the card holds nothing else
    log(f"phase 20 (d): tensor, sequence and expert parallelism on a (1, {TP_WORLD}) mesh, "
        f"{TP_WORLD} ranks sharing the card over gloo through the host, each config at full "
        f"width (float32 twin (layers, batch, seq); {TP_STEPS} bf16 steps (layers, batch, seq, "
        f"microbatches, compression), remat; serve (layers, batch, prompt) and {TP_DECODE} "
        f"decode steps): "
        + "; ".join(f"{configs.get(p['arch']).name} ({configs.get(p['arch']).n_layers} layers) "
                    f"twin {p['twin']}, train {p['train']}, serve {p['serve']}"
                    for p in TP_PARTS)
        + " (cut for the script's time: TinyLlama from 22 layers to 2, its twin from 4 to 2 "
        "layers and 2 to 1 row)"
        + f"; then a ({TP_WORLD}, 1) part: {configs.get(TP_DP['arch']).name} at "
        f"{TP_DP['layers']} layer, a gradient stage of {TP_DP['train'][0]} x "
        f"{TP_DP['train'][1]} and a prefill of {TP_DP['serve'][0]} x {TP_DP['serve'][1]}, "
        f"every MoE route over the dp group's whole microbatch")
    placed["tp"] = phase_tp()
    tp0 = placed["tp"]["ranks"][0]["parts"]
    tp_l, tp_d, tp_s, tp_r, tp_h, tp_e = (tp0[a] for a in (
        "tinyllama_1_1b", "dbrx_132b", "llama4_scout_17b_a16e", "rwkv6_1_6b", "hymba_1_5b",
        "seamless_m4t_medium"))

    head = next(s for s in shapes if s["case"] == "leaves40_f32")
    phead = next(s for s in pshapes if s["case"] == "pm256_f32")
    whead = next(s for s in wshapes if s["case"] == "prefill_8x1024")
    bhead = next(s for s in bshapes if s["case"] == "train_1x2048")
    fhead = next(s for s in fshapes if s["case"] == "prefill_8x2048")
    chead = next(s for s in cshapes if s["case"] == "mlp_leaf")
    kernels = [{
        "name": "segment_sum", "route": "cuda",
        "source": "src/repro_torch/csrc/segment_sum.cu",
        "replaces": "src/repro/kernels/segment_sum/segment_sum.py:45",
        "launches": serve["launches"], "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": "bytes", "library_ms": head["library_ms"],
        "shape": {k: head[k] for k in ("K", "n", "C", "n_keys", "dtype", "ids")},
        "launches_by_path": {"serve": serve["launches"],
                             "coeff_fit": coeff["segment_sum_launches_b"],
                             "hist_fit": coeff["segment_sum_launches"],
                             "hist_fit_histogram_route": coeff["hist_launches"],
                             "maintain": maintain["launches"],
                             "retrain": retrain["launches"],
                             "operate_service": operate["launches"]["service"],
                             "operate_stacked": operate["launches"]["stacked"],
                             "operate_follow": operate["launches"]["follow"],
                             "data_parallel_2_ranks": dp["launches"],
                             "bridge_fit": bridge["fit_launches"],
                             "bridge_weights_pass": bridge["pass_launches"]},
        "shapes": shapes,
    }, {
        "name": "polymul", "route": "cuda",
        "source": "src/repro_torch/csrc/polymul.cu",
        "replaces": "src/repro/kernels/polymul/polymul.py:44",
        "launches": coeff["polymul_launches"], "max_abs_err": phead["max_abs_err"],
        "ms": phead["ms"], "plain_ms": phead["plain_ms"], "bound_ms": phead["bound_ms"],
        "bound_by": phead["bound_by"], "library_ms": phead["library_ms"],
        "shape": {k: phead[k] for k in ("B", "k", "dtype")},
        "launches_by_path": {"coeff_fit": coeff["polymul_launches"]},
        "shapes": pshapes,
    }, {
        "name": "rwkv6_chunk", "route": "cuda",
        "source": "src/repro_torch/csrc/rwkv6_chunk.cu",
        "replaces": "src/repro/kernels/rwkv6_chunk/rwkv6_chunk.py:60",
        "launches": lm["launches"], "max_abs_err": whead["max_abs_err"],
        "ms": whead["ms"], "plain_ms": whead["plain_ms"], "bound_ms": whead["bound_ms"],
        "bound_by": whead["bound_by"], "library_ms": None,   # no single PyTorch call
        "shape": {k: whead[k] for k in ("B", "S", "H", "hs", "chunk")},
        "launches_by_path": {"lm_prefill": lm["launches_prefill"],
                             "lm_decode": lm["launches_decode"],
                             f"lm_train_{RWKV_STEPS}_steps": rwkv_train["launches"]["rwkv6_chunk"],
                             "lm_train_tp_2_steps_rank0": tp_r["train_launches"]["rwkv6_chunk"],
                             "lm_prefill_tp_rank0": tp_r["prefill_launches"]["rwkv6_chunk"],
                             "lm_decode_tp_rank0": tp_r["decode_launches"]["rwkv6_chunk"]},
        "strong_decay": wstrong,
        "shapes": wshapes,
    }, {
        "name": "rwkv6_chunk_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/rwkv6_chunk_bwd.cu",
        "replaces": "src/repro/models/rwkv6.py:81 (rwkv_chunked, differentiated by jax.grad; "
                    "the gradient of src/repro/kernels/rwkv6_chunk/rwkv6_chunk.py:60)",
        "launches": rwkv_train["launches"]["rwkv6_chunk_bwd"],
        "max_abs_err": bhead["max_abs_err"], "ms": bhead["ms"], "plain_ms": bhead["plain_ms"],
        "bound_ms": bhead["bound_ms"], "bound_by": bhead["bound_by"],
        "library_ms": None,                                  # no single PyTorch call
        "shape": {k: bhead[k] for k in ("B", "S", "H", "hs", "chunk")},
        "launches_by_path": {f"lm_train_{RWKV_STEPS}_steps":
                                 rwkv_train["launches"]["rwkv6_chunk_bwd"],
                             "lm_train_tp_2_steps_rank0":
                                 tp_r["train_launches"]["rwkv6_chunk_bwd"]},
        "shapes": bshapes,
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:66",
        "launches": dense["launches"], "max_abs_err": fhead["max_abs_err"],
        "ms": fhead["ms"], "plain_ms": fhead["plain_ms"], "bound_ms": fhead["bound_ms"],
        "bound_by": fhead["bound_by"], "library_ms": fhead["library_ms"],
        "shape": {k: fhead[k] for k in ("B", "S", "N", "Kh", "dh", "causal", "dtype")},
        "launches_by_path": {"lm_prefill": dense["launches_prefill"],
                             "lm_decode": dense["launches_decode"],
                             "lm_train_4_steps": train["launches"]["flash_attention"],
                             **{f"serve_{d['arch']}_prefill": d["launches_prefill"]
                                for d in dense_serve},
                             "serve_hymba_1_5b_prefill": hymba["launches_prefill"],
                             "serve_hymba_1_5b_decode": hymba["launches_decode"],
                             "lm_train_hymba_1_5b_4_steps":
                                 hymba_train["launches"]["flash_attention"],
                             "lm_train_hymba_1_5b_4_steps_windowed":
                                 hymba_train["launches"]["flash_attention_windowed"],
                             **{f"serve_{d['arch']}_prefill": d["launches_prefill"]
                                for d in moe_serve},
                             **{f"serve_{d['arch']}_decode": d["launches_decode"]
                                for d in moe_serve},
                             **{f"lm_train_{d['arch']}_4_steps": d["launches"]["flash_attention"]
                                for d in moe_train},
                             "serve_seamless_prefill": encdec_serve["launches_prefill"],
                             "serve_seamless_prefill_noncausal":
                                 encdec_serve["counts_prefill"]["noncausal_launches"],
                             "serve_seamless_decode": encdec_serve["launches_decode"],
                             "lm_train_seamless_4_steps":
                                 encdec_train["launches"]["flash_attention"],
                             "lm_train_seamless_4_steps_noncausal":
                                 encdec_train["launches"]["flash_attention_noncausal"],
                             "serve_llava_prefill": llava["launches_prefill"],
                             "serve_llava_decode": llava["launches_decode"],
                             "lm_train_placed_2_steps":
                                 placed["launches"]["flash_attention"],
                             "lm_train_tp_2_steps_rank0":
                                 tp_l["train_launches"]["flash_attention"],
                             "serve_tp_prefill_rank0": tp_l["prefill_launches"]["flash_attention"],
                             "serve_tp_decode_rank0": tp_l["decode_launches"]["flash_attention"],
                             "lm_train_tp_dbrx_2_steps_rank0":
                                 tp_d["train_launches"]["flash_attention"],
                             "serve_tp_dbrx_prefill_rank0":
                                 tp_d["prefill_launches"]["flash_attention"],
                             "serve_tp_dbrx_decode_rank0":
                                 tp_d["decode_launches"]["flash_attention"],
                             "serve_tp_scout_prefill_rank0":
                                 tp_s["prefill_launches"]["flash_attention"],
                             "serve_tp_scout_decode_rank0":
                                 tp_s["decode_launches"]["flash_attention"],
                             **{f"{k}_tp_{tag}_rank0{sub}":
                                    r[f"{k}_launches"][f"flash_attention{sub}"]
                                for tag, r, subs in (("hymba", tp_h, ("", "_windowed")),
                                                     ("seamless", tp_e, ("", "_noncausal")))
                                for k in ("train", "prefill", "decode") for sub in subs}},
        "sass_bf16": fsass,
        "shapes": fshapes,
    }, {
        "name": "count_sketch", "route": "cuda",
        "source": "src/repro_torch/csrc/count_sketch.cu",
        "replaces": "src/repro/kernels/count_sketch/count_sketch.py:45",
        "launches": train["launches"]["count_sketch"], "max_abs_err": chead["max_abs_err"],
        "ms": chead["ms"], "plain_ms": chead["plain_ms"], "bound_ms": chead["bound_ms"],
        "bound_by": chead["bound_by"], "library_ms": chead["library_ms"],
        "shape": {k: chead[k] for k in ("n", "k")},
        "launches_by_path": {"lm_train_4_steps": train["launches"]["count_sketch"],
                             "lm_train_4_steps_unsketch":
                                 train["launches"]["count_sketch_unsketch"],
                             f"rwkv_train_{RWKV_STEPS}_steps":
                                 rwkv_train["launches"]["count_sketch"],
                             f"rwkv_train_{RWKV_STEPS}_steps_unsketch":
                                 rwkv_train["launches"]["count_sketch_unsketch"],
                             "hymba_train_4_steps": hymba_train["launches"]["count_sketch"],
                             "hymba_train_4_steps_unsketch":
                                 hymba_train["launches"]["count_sketch_unsketch"],
                             "seamless_train_4_steps": encdec_train["launches"]["count_sketch"],
                             "seamless_train_4_steps_unsketch":
                                 encdec_train["launches"]["count_sketch_unsketch"],
                             "placed_train_2_steps": placed["launches"]["count_sketch"],
                             "placed_train_2_steps_unsketch":
                                 placed["launches"]["count_sketch_unsketch"],
                             "tp_train_2_steps_rank0": tp_l["train_launches"]["count_sketch"],
                             "tp_train_2_steps_unsketch_rank0":
                                 tp_l["train_launches"]["count_sketch_unsketch"],
                             "tp_rwkv_train_2_steps_rank0":
                                 tp_r["train_launches"]["count_sketch"],
                             "tp_rwkv_train_2_steps_unsketch_rank0":
                                 tp_r["train_launches"]["count_sketch_unsketch"],
                             "tp_hymba_train_2_steps_rank0": tp_h["train_launches"]["count_sketch"],
                             "tp_hymba_train_2_steps_unsketch_rank0":
                                 tp_h["train_launches"]["count_sketch_unsketch"]},
        "shapes": cshapes,
    }]
    log(json.dumps({"serve": serve, "paper": paper, "coeff_hist": coeff, "lm": lm,
                    "lm_dense": dense, "lm_train": train, "maintain": maintain,
                    "retrain": retrain, "phase8_s": phase8_s, "operate": operate,
                    "data_parallel": dp, "bridge": bridge, "lm_rwkv_train": rwkv_train,
                    "dense_serve": dense_serve, "hymba_serve": hymba,
                    "hymba_train": hymba_train, "moe_serve": moe_serve, "moe_train": moe_train,
                    "encdec_serve": encdec_serve, "encdec_train": encdec_train,
                    "llava_serve": llava, "placed": placed, "host_state": host}))
    log(json.dumps({"kernels": kernels}))
    # count: the cards this process sees (the run drives device 0)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
