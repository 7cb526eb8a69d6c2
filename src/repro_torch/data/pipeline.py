"""Deterministic, shardable token data pipeline; the port of
``repro.data.pipeline``.

Sources: a synthetic LM stream (seeded zipf-ish token model, always
available offline) or a binary token file (``np.memmap``).  Each data
shard draws disjoint slices by (shard_id, num_shards); batches are
functions of (seed, step), so a restart from a checkpoint replays the
exact stream.  A bounded prefetch thread hides generation latency.

Batches are numpy int32 arrays equal to the reference's byte for byte.
The synthetic source's zipf draw goes through ``sim.trace_gen._zipf``,
numpy 2.0's sampler on any numpy (numpy changed ``Generator.zipf``
after 2.0), which leaves the generator where ``rng.zipf`` does, so the
copy spans drawn after it agree too.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from repro_torch.sim.trace_gen import _zipf

# no effective cap: every sample numpy 2.0's sampler accepts stays
_NO_CAP = np.iinfo(np.int64).max


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    batch: int              # per-shard batch
    seq_len: int
    seed: int = 0
    path: Optional[str] = None   # token file (int32 flat) -- else synthetic
    shard_id: int = 0
    num_shards: int = 1
    prefetch: int = 2


class _Synthetic:
    """Zipf-mixture token stream with local n-gram structure, so losses
    actually decrease during the examples' training runs."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * cfg.num_shards + cfg.shard_id)
        B, S, V = cfg.batch, cfg.seq_len, cfg.vocab_size
        base = _zipf(rng, 1.3, B * S, _NO_CAP).reshape(B, S) % V
        # inject copy structure: spans repeat earlier content (learnable)
        for _ in range(2):
            src = rng.integers(0, S // 2, size=B)
            dst = rng.integers(S // 2, S - S // 4, size=B)
            ln = S // 8
            for b in range(B):
                base[b, dst[b]:dst[b] + ln] = base[b, src[b]:src[b] + ln]
        return base.astype(np.int32)


class _FileSource:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.tokens = np.memmap(cfg.path, dtype=np.int32, mode="r")

    def batch_at(self, step: int) -> np.ndarray:
        cfg = self.cfg
        n = cfg.batch * cfg.seq_len
        total = len(self.tokens) - n - 1
        off = ((step * cfg.num_shards + cfg.shard_id) * n) % max(total, 1)
        return np.asarray(self.tokens[off:off + n]).reshape(
            cfg.batch, cfg.seq_len)


class Pipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.src = _FileSource(cfg) if cfg.path else _Synthetic(cfg)
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._thread = None
        self._stop = threading.Event()

    def batch_at(self, step: int) -> np.ndarray:
        """Random access -- used for deterministic restart replay."""
        return self.src.batch_at(step)

    def iterate(self, start_step: int = 0) -> Iterator[np.ndarray]:
        """Prefetching iterator starting at `start_step`."""
        self._stop.clear()

        def worker():
            s = start_step
            while not self._stop.is_set():
                self._q.put((s, self.src.batch_at(s)))
                s += 1

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        while True:
            step, b = self._q.get()
            yield b

    def close(self):
        self._stop.set()
        if self._thread is not None:
            while not self._q.empty():
                self._q.get_nowait()
