"""Deterministic, resumable synthetic token pipeline (mirrors
``src/repro/data/pipeline.py``; numpy only, the reference's unused
``jax`` import dropped).

Production posture without external datasets: token streams are
generated from a counter-based PRNG (threefry over (seed, step, shard)),
which gives the three properties a 1000-node fleet needs:

* **determinism** — batch ``t`` is a pure function of (seed, t), so a
  restarted job reproduces the exact stream;
* **resumability** — the pipeline cursor is one integer, stored in the
  checkpoint; no file offsets to replay;
* **host-sharding** — each data-parallel host materializes only its
  shard of the global batch (``host_slice``).

The synthetic distribution is a Zipf-ish unigram mix with a Markov
bigram component, so CE losses move meaningfully during the example
runs (pure-uniform tokens would pin the loss at log V).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # fixed unigram table (host-side, deterministic in seed)
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_alpha)
        self._probs = (probs / probs.sum()).astype(np.float64)
        self._perm = rng.permutation(cfg.vocab)

    # ------------------------------------------------------------------
    def batch_at(self, step: int,
                 host_slice: Optional[Tuple[int, int]] = None
                 ) -> Dict[str, np.ndarray]:
        """The global (or host-sliced) batch for ``step`` — pure function.

        host_slice = (host_index, host_count) -> rows
        [host_index * B/host_count, ...) only.
        """
        cfg = self.cfg
        b0, b1 = 0, cfg.global_batch
        if host_slice is not None:
            idx, cnt = host_slice
            per = cfg.global_batch // cnt
            b0, b1 = idx * per, (idx + 1) * per
        rows = []
        for b in range(b0, b1):
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, b]))
            uni = rng.choice(cfg.vocab, size=cfg.seq_len + 1, p=self._probs)
            # Markov component: with p=0.5 repeat-shift the previous token
            rep = rng.random(cfg.seq_len + 1) < 0.5
            seq = uni.copy()
            for t in range(1, cfg.seq_len + 1):
                if rep[t]:
                    seq[t] = (seq[t - 1] * 31 + 7) % cfg.vocab
            rows.append(self._perm[seq])
        toks = np.stack(rows).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    # ------------------------------------------------------------------
    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
