"""Count-sketch gradient compression with error feedback, the port of the
reference's ``optim/grad_compress.py``.

Each gradient leaf g of n elements (flattened; a leaf stacked over layers
is one leaf, t = layer · numel + offset) is sketched into k buckets,
S·x with x = g + e (e the error-feedback state), under 2-universal hashes
h, s that rotate every round; the estimate is ĝ[t] = s(t) · S·x[h(t)],
scaled by k/n with error feedback (the contractive form), and the new
state is x − ĝ.  Leaves with n < 4 · ratio pass unsketched.  k is the
reference's rule: the power of two above n // ratio, at most the one
above n.  A leaf of more than 2³¹ − 1 elements, which the kernel does
not take, is refused before anything is updated (never truncated).

On the card both passes are the count_sketch kernel's
(``kernels/count_sketch``): the sketch hashes t inside the kernel, and
the unsketch writes ĝ over the gradient leaf and x − ĝ over the state in
one pass, so no index array and no copy of a leaf is made.  On the CPU
they are the plain versions.  The call updates the gradient leaves and
its state in place.

Semantics are the reference's called eagerly, as its docstring and tests
describe: fresh hashes every round, and the error-feedback state carried
from round to round.  (Under ``jax.jit`` the reference's compressor runs
once, at trace time: ROADMAP §3.)  The hashes come from
``Hash2.make(np.random.default_rng((seed, i, round)), k)``, not from the
reference's ``jax.random`` keys; the tests inject the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

from ..core.sketch import Hash2
from ..kernels.count_sketch import count_sketch_hashed, unsketch
from ..kernels.count_sketch.ops import N_MAX
from ..tree import leaves


@dataclasses.dataclass
class CountSketchCompressor:
    """ratio: |g| / k compression per leaf.  Stateful (error feedback)."""

    ratio: int = 8
    seed: int = 0
    error_feedback: bool = True
    _state: Optional[List[Optional[torch.Tensor]]] = None
    _round: int = 0

    def sketch_size(self, n: int) -> int:
        k = max(2, 1 << max(1, n // self.ratio).bit_length())
        return min(k, 1 << max(1, n.bit_length()))

    def _leaf_hash(self, i: int, n: int) -> Hash2:
        """Fresh hashes every round: a fixed sketch is a fixed rank-k
        projector whose null space error feedback can never transmit."""
        return Hash2.make(np.random.default_rng((self.seed, i, self._round)),
                          self.sketch_size(n))

    def __call__(self, grads) -> Any:
        """Replace each float32 leaf of ``grads`` by its estimate, in place;
        returns ``grads``."""
        flat = [g.view(-1) for g in leaves(grads)]
        big = [i for i, g in enumerate(flat) if g.shape[0] > N_MAX]
        if big:                         # refused before any leaf or state is touched
            raise ValueError(
                f"compressor: leaves {big} hold {[flat[i].shape[0] for i in big]} elements; the "
                f"count_sketch kernel takes at most {N_MAX} (a stacked expert leaf of DBRX "
                f"passes it at 3 layers): train such a model without compression")
        if self._state is None:
            self._state = [torch.zeros_like(g) if self.error_feedback else None for g in flat]
        for i, g in enumerate(flat):
            n = g.shape[0]
            if g.dtype != torch.float32 or not g.is_contiguous():
                raise TypeError(f"compressor takes contiguous float32 leaves, leaf {i} is "
                                f"{g.dtype}")
            st = self._state[i]
            if n < 4 * self.ratio:              # tiny leaves: sent uncompressed
                if st is not None:
                    st.zero_()
                continue
            h = self._leaf_hash(i, n)
            if st is None:
                sk = count_sketch_hashed(g, h)
                unsketch(g, sk, h, est=g)
            else:
                x = st.add_(g)                  # x = g + e, in the state's buffer
                sk = count_sketch_hashed(x, h)
                unsketch(x, sk, h, h.k / n, est=g, state=x)
            del sk
        self._round += 1
        return grads

    def state_tree(self, params) -> dict:
        """What a checkpoint keeps of the compressor: the round (it seeds the
        hashes) and the error-feedback buffers, one float32 vector a leaf of
        ``params`` (zero before the first round; absent without error
        feedback)."""
        if self._state is None:
            self._state = [torch.zeros(p.numel(), dtype=torch.float32, device=p.device)
                           if self.error_feedback else None for p in leaves(params)]
        return {"round": torch.tensor(self._round, dtype=torch.int64),
                "error": list(self._state)}

    def load_state_tree(self, tree: dict) -> None:
        """Take the round and the buffers of :meth:`state_tree`'s tree."""
        self._round = int(tree["round"])
        self._state = list(tree["error"])

    def compressed_bytes(self, grads) -> int:
        total = 0
        for leaf in leaves(grads):
            n = leaf.numel()
            total += (n if n < 4 * self.ratio else self.sketch_size(n)) * 4
        return total
