"""Deterministic synthetic data pipeline (numpy; the port's own copy).

Stateless by construction: ``batch(step)`` is a pure function of
(seed, step, shape), so a restarted job resumes mid-epoch with no data state
to checkpoint. Each host materializes only its slice of the global batch
(``host_index``/``host_count``), drawn from the same global stream, so the
data do not depend on the topology. Bit-identical to the reference's
``repro.data.pipeline`` for the same arguments.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    cfg: ModelConfig
    global_batch: int
    seq_len: int
    seed: int = 0

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.global_batch, self.seq_len])
        )

    def batch(self, step: int, *, host_index: int = 0, host_count: int = 1) -> dict:
        b = self.global_batch // host_count
        rng = self._rng(step)
        # draw the full global batch then slice: identical global data regardless
        # of host topology (elastic restarts keep the data stream stable)
        toks = rng.integers(0, self.cfg.vocab, size=(self.global_batch, self.seq_len + 1),
                            dtype=np.int32)
        sl = slice(host_index * b, (host_index + 1) * b)
        out = {"tokens": toks[sl, :-1], "labels": toks[sl, 1:]}
        if self.cfg.input_kind == "embeddings":  # vision/audio stub inputs
            out["embeds"] = rng.standard_normal(
                (self.global_batch, self.seq_len, self.cfg.d_model), dtype=np.float32
            )[sl]
            del out["tokens"]
        if self.cfg.enc_layers:
            out["enc_embeds"] = rng.standard_normal(
                (self.global_batch, self.cfg.enc_seq, self.cfg.d_model), dtype=np.float32
            )[sl]
        return out


def batch_for_cell(cfg: ModelConfig, seq_len: int, global_batch: int, step: int = 0) -> dict:
    return SyntheticLM(cfg, global_batch, seq_len).batch(step)
