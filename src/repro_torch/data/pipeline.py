"""Deterministic, host-sharded, prefetching data pipeline (the port of the
reference's ``data/pipeline.py``, numpy only).

- Host sharding: each process draws only its slice of the global batch
  (seeded by (stream seed, step, process)); restart at step N reproduces
  the exact stream — checkpoint-resume is bitwise deterministic, and the
  port draws the same batches as the reference for the same seed.
- Prefetch: a background thread keeps `depth` batches ready.
- Straggler hook: the runtime watchdog can call ``reassign(host)`` to
  redistribute a slow host's shard (runtime/fault.py).
- Relational feature stage (the paper's integration): a booster trained
  relationally scores every fact row in one SumProd pass
  (:func:`relational_example_weights`), and ``example_weights`` turns
  those scores into the probabilities by which the pipeline draws its
  documents, each batch with its ``doc_ids``.  ``make_batch`` replaces the
  drawing altogether.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from .synthetic import SyntheticLM


class TokenPipeline:
    def __init__(
        self,
        vocab: int,
        global_batch: int,
        seq_len: int,
        seed: int = 0,
        depth: int = 2,
        n_hosts: int = 1,
        host_id: int = 0,
        example_weights: Optional[np.ndarray] = None,
        make_batch: Optional[Callable] = None,
    ):
        self.spec = (global_batch, seq_len)
        self.n_hosts, self.host_id = n_hosts, host_id
        self.seed = seed
        self.gen = SyntheticLM(vocab, seed=seed)
        self.make_batch = make_batch
        self.weights = example_weights
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = 0
        self._gen = 0           # bumped on seek/reassign; stale batches dropped
        self._lock = threading.Lock()   # (gen, step) change together
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._dead_hosts: set = set()
        self._thread.start()

    # ------------------------------------------------------------ control --
    def reassign(self, host: int):
        """Straggler mitigation: fold a slow host's shard into the others."""
        with self._lock:
            self._dead_hosts.add(host)
            self._gen += 1

    def seek(self, step: int):
        """Deterministic resume: restart production at `step`."""
        with self._lock:
            self._gen += 1
            self._step = step
            with self._q.mutex:
                self._q.queue.clear()

    def stop(self):
        """End the producer thread (it exits within 0.1 s, also when the
        queue is full) and wait for it."""
        self._stop.set()
        self._thread.join(timeout=5.0)

    # ----------------------------------------------------------- producer --
    def _host_rows(self, step: int):
        G = self.spec[0]
        alive = [h for h in range(self.n_hosts) if h not in self._dead_hosts]
        per = G // len(alive)
        mine = alive.index(self.host_id) if self.host_id in alive else 0
        return per, mine

    def _produce(self, step: int) -> Dict[str, np.ndarray]:
        S = self.spec[1]
        per, mine = self._host_rows(step)
        rng = np.random.default_rng((self.seed, step, mine))
        if self.make_batch is not None:
            return self.make_batch(rng, per, S)
        if self.weights is not None:
            # importance-sample corpus docs by their weights, then synthesise
            # each drawn doc from (seed, doc) alone, so a doc id gives the same
            # token row at every step and on every host; skewed weights repeat
            # docs, so each distinct doc is made once and indexed back
            p = self.weights / self.weights.sum()
            keep = rng.choice(len(p), size=per, p=p)
            uniq, inv = np.unique(keep, return_inverse=True)
            rows = np.stack([
                self.gen.batch(np.random.default_rng((self.seed, int(d))), 1, S)[0]
                for d in uniq
            ])
            return {"tokens": rows[inv], "doc_ids": keep.astype(np.int64)}
        return {"tokens": self.gen.batch(rng, per, S)}

    def _producer(self):
        while not self._stop.is_set():
            with self._lock:
                gen, step = self._gen, self._step
            b = self._produce(step)
            while not self._stop.is_set():
                try:
                    self._q.put((gen, step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            with self._lock:
                # Advance only if no seek or reassignment came meanwhile: a
                # stale batch is dropped and its step produced again under the
                # new generation (comparing steps instead would skip a step
                # when a seek targets the step in flight).
                if self._gen == gen:
                    self._step = step + 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self):
        while True:
            gen, _step, b = self._q.get()
            if gen == self._gen:       # drop batches produced pre-seek
                return b


def relational_example_weights(booster, trees, group_table: str) -> np.ndarray:
    """Per-row sampling weights of ``group_table`` from a relationally
    trained booster: every row's mean prediction over ρ⋈J from one pass of
    the compiled one-pass scorer (no join materialised, one SumProd
    evaluation, on the booster's device), softmaxed:
    ``score = Σŷ / max(count, 1)``, ``w = exp(score − max score) / Σ``.
    Returns a float32 numpy array (the reference's dtype: its sums are
    float32)."""
    from ..serving import compile_ensemble

    tot, cnt = compile_ensemble(booster.schema, trees).score_grouped(group_table)
    score = tot.to(torch.float32) / torch.clamp(cnt.to(torch.float32), min=1.0)
    w = torch.exp(score - score.max())
    return (w / w.sum()).cpu().numpy()
