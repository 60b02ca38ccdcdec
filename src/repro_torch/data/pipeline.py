"""Deterministic synthetic data pipeline.

Port of ``repro/data/pipeline.py``: seeded token streams (and stub modality
embeddings) with an index-based ``get_batch(step)``, so a restart resumes
mid-stream without replaying (a checkpoint stores only the step counter).

The semantics are the reference's: tokens ``(base + cumsum(drift)) %
vocab`` with ``base`` uniform over the vocabulary and ``drift`` uniform over
{0, 1, 2}, targets the tokens shifted by one, image and source-frame stubs
at 0.02 scale.  The numbers are the port's own: each batch is drawn by an
explicit ``torch.Generator`` seeded from ``(seed, step)`` (through
numpy's ``SeedSequence``) on the CPU and then moved, so a batch on the
card equals the same batch on the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int
    seq: int
    vocab: int
    seed: int = 0
    # modality stubs
    image_tokens: int = 0
    d_model: int = 0
    src_frames: int = 0


class SyntheticStream:
    """Markov-ish synthetic tokens: deterministic per (seed, step)."""

    def __init__(self, cfg: DataConfig, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)

    def get_batch(self, step: int) -> dict:
        c = self.cfg
        # the CPU generator keeps 32 bits of its seed: (seed, step) are
        # mixed into them first, so no two pairs share a stream by accident
        gen = torch.Generator().manual_seed(int(
            np.random.SeedSequence([c.seed, step]).generate_state(1)[0]))
        # token stream with local correlation (so the loss is learnable)
        base = torch.randint(0, c.vocab, (c.batch, c.seq + 1), generator=gen)
        drift = torch.cumsum(
            torch.randint(0, 3, (c.batch, c.seq + 1), generator=gen), dim=1)
        tokens = ((base + drift) % c.vocab).to(torch.int32)
        batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
        if c.image_tokens:
            batch["image_embeds"] = torch.randn(
                (c.batch, c.image_tokens, c.d_model), generator=gen) * 0.02
        if c.src_frames:
            batch["src_embeds"] = torch.randn(
                (c.batch, c.src_frames, c.d_model), generator=gen) * 0.02
        return {k: v.contiguous().to(self.device) for k, v in batch.items()}


def for_arch(arch_cfg, batch: int, seq: int, seed: int = 0,
             device="cpu") -> SyntheticStream:
    """Stream shaped for an architecture (modality stubs included)."""
    dec_seq = seq // 4 if arch_cfg.enc_layers else seq
    return SyntheticStream(DataConfig(
        batch=batch,
        seq=max(dec_seq, 8),
        vocab=arch_cfg.vocab,
        seed=seed,
        image_tokens=arch_cfg.n_frontend_tokens if arch_cfg.frontend == "vision" else 0,
        d_model=arch_cfg.d_model,
        src_frames=seq if arch_cfg.enc_layers else 0,
    ), device)
